"""Remote actors: actor-only hosts feeding a learner over TCP, the port of
the JAX package's runtime/remote.py under its names and its wire protocol.

The reference runs actor processes against the learner through the TF
gRPC runtime: actors hold their own env and inference graph, read the
learner's weights, and enqueue into the learner-hosted queue. Here:

- The learner runs a `TrajectoryIngestServer` beside its
  `TrajectoryBuffer`: remote unrolls land in the same buffer a local
  fleet feeds, so batching, staging and the train step do not know where
  an unroll came from.
- An actor-only host runs `run_remote_actor()` (`python -m
  scalable_agent_tpu_torch.experiment --job_name=actor
  --learner_address=host:port`): an `ActorFleet` and its own
  `InferenceServer` on the host's device, a local buffer, and a pump that
  ships unrolls to the learner and fetches fresh params when an ack
  reports a newer version.

The wire: length-prefixed frames over TCP, strict request -> reply per
socket. PLAIN frames carry one pickle; OOB frames a pickle-protocol-5
skeleton plus the arrays' raw buffers out of band, so an unroll's frames
are never copied through the pickler. Only numpy arrays ride a frame
(a torch tensor would pickle in band). Backpressure is end to end: a
full learner buffer blocks the ingest worker's put, which holds the
ack, which holds the actor's pump.

Two lanes per actor host. The trajectory lane: one reader thread per
connection receives and parses, and a small validate/commit worker pool
validates the unroll against the handshake's contract, puts it into the
buffer and acks. The param lane: a second connection opened with
'hello_params', served by one selector thread that writes the cached
per-version snapshot in bounded chunks, so blob traffic never queues
the acks. Snapshots ship bfloat16 by default (config.publish_codec;
int8 to protocol-10 subscribers under 'int8'), one serialization per
published version.

Liveness: every blocking socket path has a deadline. Readers poll
(`_ConnLiveness`: a peer silent mid-frame is reaped), sends are
progress-bounded (`_sendall_bounded`), an idle reaper closes connections
silent past `remote_conn_idle_timeout_secs` on both lanes, idle clients
ping, and workers' readers send ('busy',) keepalives while backpressure
holds an ack. A per-run session epoch rides the handshake, so a
restarted learner tells reattaching clients from fresh ones and refuses
unrolls stamped with a dead incarnation's epoch. A `ThreadWatchdog`
counts service threads that still wedge.

Integrity: on a CRC-negotiated connection every frame carries a CRC32C
trailer (integrity.py); the ingest worker checks it before the put and
answers ('corrupt', crc); the client resends once, then goes through a
probation probe (`CrcProbation`) before it quarantines itself. Param
publishes carry a content digest of the wire form, which the client
checks before anything is installed.

Protocol versions 5..10 interoperate: each extension (heartbeats and the
epoch in 6, CRC and digests in 7, trace stamps in 8, membership in 9,
int8 blobs and the 'infer' kind in 10) is negotiated per connection at
hello and is off for an older peer. Routed inference ('infer',
`attach_serving`; the client's `remote_infer`, which runtime/routing.py
spreads over replicas) answers ('error', 'serving not attached') until
something is attached; driver.train attaches its InferenceServer's
`serve_remote` after the warmup.

Trust: pickle over cluster-internal sockets, the reference's trust in
its unauthenticated gRPC runtime. Never expose the ingest port outside
the job's network; the CRC is an integrity check, not authentication.
"""

import logging
import os
import pickle
import queue
import random
import select
import selectors
import signal
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis.runtime import guarded_by, make_lock
from scalable_agent_tpu_torch.observability import ThreadWatchdog
from scalable_agent_tpu_torch.runtime import codec as codec_lib
from scalable_agent_tpu_torch.runtime import faults as faults_lib
from scalable_agent_tpu_torch.runtime import ring_buffer

log = logging.getLogger('scalable_agent_tpu_torch')

_LEN = struct.Struct('>Q')
_MAX_MSG = 1 << 32  # 4 GiB sanity bound
# The CRC32C trailer: 4 big-endian bytes after the payload on a
# CRC-negotiated connection. The length prefix counts tag + payload only.
_CRC = struct.Struct('>I')
# Frame kinds (one tag byte after the length prefix).
_FRAME_PLAIN = 0
_FRAME_OOB = 1
_OOB_META = struct.Struct('>II')    # (num buffers, skeleton length)
_OOB_BUFLEN = struct.Struct('>Q')
# Remote actor hosts' seed space: far above any learner rank's
# rank * max(num_actors, 1000) base, so their streams never collide.
_REMOTE_SEED_SPACE = 1 << 24


def _plain_frame(payload: bytes, crc: bool = False) -> bytes:
  """One PLAIN wire frame of pre-pickled bytes, with the CRC trailer
  (over tag + payload) when `crc`."""
  body = bytes((_FRAME_PLAIN,)) + payload
  frame = _LEN.pack(len(body)) + body
  if crc:
    frame += _CRC.pack(integrity.crc_bytes(body))
  return frame


def _send_msg(sock: socket.socket, obj, crc: bool = False) -> None:
  sock.sendall(_plain_frame(
      pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), crc=crc))


# Buffers at or below this coalesce into one sendall with their
# neighbours: a syscall per small array costs more than the copy.
_OOB_COALESCE = 128 * 1024


def _oob_frame_segments(obj) -> List:
  """The OOB wire frame of `obj` as segments for sendall: [head (length
  prefix + tag + meta + skeleton + buffer table), raw buffer, ...]."""
  buffers = []
  skeleton = pickle.dumps(obj, protocol=5,
                          buffer_callback=buffers.append)
  raws = [b.raw() for b in buffers]
  lens = b''.join(_OOB_BUFLEN.pack(r.nbytes) for r in raws)
  total = (1 + _OOB_META.size + len(skeleton) + len(lens)
           + sum(r.nbytes for r in raws))
  head = (_LEN.pack(total) + bytes((_FRAME_OOB,))
          + _OOB_META.pack(len(raws), len(skeleton))
          + skeleton + lens)
  return [head] + raws


def _segments_crc(segments) -> int:
  """CRC32C over an OOB frame's content: segment 0 without its length
  prefix, then every raw buffer."""
  acc = integrity.Crc()
  acc.update(memoryview(segments[0])[_LEN.size:])
  for raw in segments[1:]:
    acc.update(raw)
  return acc.value


def _send_segments(sock: socket.socket, segments,
                   trailer: Optional[bytes] = None) -> None:
  """Stream a frame's segments, coalescing small ones; `trailer` (the
  CRC bytes) rides the final flush."""
  pending = [segments[0]]

  def flush():
    if not pending:
      return
    sock.sendall(pending[0] if len(pending) == 1
                 else b''.join(pending))
    pending.clear()

  for raw in segments[1:]:
    if memoryview(raw).nbytes <= _OOB_COALESCE:
      pending.append(raw)
      if sum(len(p) for p in pending) > _OOB_COALESCE:
        flush()
    else:
      flush()
      sock.sendall(raw)
  if trailer is not None:
    pending.append(trailer)
  flush()


def _send_oob(sock: socket.socket, obj, crc: bool = False) -> None:
  """Ship `obj` as an OOB frame. With `crc` the trailer is computed
  before the wire_bitflip fault site runs, so an injected flip ships
  with a stale trailer: the corruption the check exists to catch."""
  segments = _oob_frame_segments(obj)
  trailer = _CRC.pack(_segments_crc(segments)) if crc else None
  plan = faults_lib.active()
  fault = faults_lib.fire('wire_bitflip')
  if fault is not None:
    segments = faults_lib.apply_wire_bitflip(
        fault, segments, seed=plan.seed if plan else 0)
  _send_segments(sock, segments, trailer)


class _CrcContext:
  """The CRC ledger of one receive on a CRC connection: `_recv_msg`
  accumulates the computed CRC over every frame piece and records the
  wire trailer; the caller compares."""

  __slots__ = ('computed', 'wire')

  def __init__(self):
    self.computed = 0
    self.wire: Optional[int] = None

  def reset(self):
    self.computed = 0
    self.wire = None

  def update(self, data):
    self.computed = integrity.crc_bytes(data, self.computed)

  @property
  def ok(self) -> bool:
    return self.wire is not None and self.wire == self.computed


class _FrameStall(OSError):
  """A peer stopped sending mid-frame past the stall deadline."""


class _ServerClosing(ConnectionError):
  """close() began while this reader polled: the reader leaves its
  connection listed and open, since close() owns the 'bye' sequence."""


class _SendStall(OSError):
  """A send made no progress past the stall deadline."""


class _ConnLiveness:
  """Receive liveness of one server reader. The socket polls with a
  short timeout; `progress(n)` refreshes the connection's last-receive
  clock and beats the watchdog, `idle(got)` (a poll timeout) beats it,
  aborts when the server closes, raises `_FrameStall` when the peer
  went silent mid-frame past the stall deadline, and sends the ('busy',)
  keepalive at the heartbeat cadence while the connection's unroll is
  in flight. `frame_bytes` counts the current frame's bytes, the
  discard ledger when a frame is thrown away."""

  def __init__(self, conn, closed_event, stall_secs, watchdog=None,
               name='', heartbeat_secs: float = 0.0):
    self._conn = conn
    self._closed = closed_event
    self._stall_secs = stall_secs
    self._watchdog = watchdog
    self._name = name
    self._heartbeat_secs = heartbeat_secs
    self._last_busy = time.monotonic()
    self.in_frame = False  # header received, frame body outstanding
    self.frame_bytes = 0

  def beat(self):
    if self._watchdog is not None:
      self._watchdog.beat(self._name)

  def progress(self, nbytes):
    if self.in_frame:
      self.frame_bytes += nbytes
    self._conn.last_recv = time.monotonic()
    self._conn.hb_missed = False
    self.beat()

  def idle(self, got):
    self.beat()
    if self._closed.is_set():
      raise _ServerClosing('server closing')
    now = time.monotonic()
    if (got or self.in_frame) and (now - self._conn.last_recv
                                   > self._stall_secs):
      raise _FrameStall(
          f'peer silent mid-frame for more than {self._stall_secs}s')
    if (self._conn.heartbeat and self._conn.is_waiting_on_us()
        and self._heartbeat_secs > 0
        and now - self._last_busy >= self._heartbeat_secs):
      self._last_busy = now
      try:
        self._conn.send(('busy',))
      except OSError:
        pass  # peer gone; the recv path will notice


def _recv_into(sock: socket.socket, view, n: int, liveness=None) -> int:
  """Fill view[:n] from the socket; returns the bytes received (< n
  only on EOF). With `liveness` the socket polls, and poll timeouts go
  to liveness.idle, received bytes to liveness.progress."""
  got = 0
  while got < n:
    try:
      r = sock.recv_into(view[got:n])
    except socket.timeout:
      if liveness is None:
        raise
      liveness.idle(got)
      continue
    if r == 0:
      return got  # EOF
    got += r
    if liveness is not None:
      liveness.progress(r)
  return got


def _recv_exact(sock: socket.socket, n: int, liveness=None):
  """n bytes as a bytearray, or None on EOF."""
  buf = bytearray(n)
  got = _recv_into(sock, memoryview(buf), n, liveness)
  if got < n:
    return None  # EOF; callers map non-header Nones to errors
  return buf


def _sendall_bounded(sock: socket.socket, data, stall_secs: float,
                     beat=None) -> None:
  """sendall with a no-progress deadline for a socket in timeout mode:
  each successful send resets the clock, a peer that reads nothing
  raises `_SendStall`."""
  view = memoryview(data)
  last_progress = time.monotonic()
  while view.nbytes:
    try:
      sent = sock.send(view)
    except socket.timeout:
      if beat is not None:
        beat()
      if time.monotonic() - last_progress > stall_secs:
        raise _SendStall(
            f'send made no progress for more than {stall_secs}s '
            f'({view.nbytes} byte(s) unsent)')
      continue
    view = view[sent:]
    last_progress = time.monotonic()


def _drain_until_quiet(sock: socket.socket, deadline: float,
                      quiet_secs: float = 0.2) -> None:
  """Read and drop what the peer still sends, until EOF, `quiet_secs`
  without a byte, or `deadline` (monotonic). Closing a socket with
  unread bytes sends an RST, which makes the peer's kernel drop what it
  had not read yet: a 'bye' written just before would be lost to a peer
  caught mid-send (its readers stopped reading at close)."""
  try:
    while True:
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        return
      sock.settimeout(min(quiet_secs, remaining))
      if not sock.recv(1 << 16):
        return
  except OSError:  # socket.timeout included: the peer went quiet
    return


def _recv_msg(sock: socket.socket, liveness=None, crc_ctx=None):
  """One message (either frame kind), or None on a clean EOF. OOB
  buffers are received straight into uninitialized numpy storage.
  `crc_ctx`: the computed CRC and the wire trailer land on it; the
  caller compares."""
  header = _recv_exact(sock, _LEN.size, liveness)
  if header is None:
    return None
  # The discard ledger resets before the length check can raise.
  if liveness is not None:
    liveness.frame_bytes = _LEN.size
  (length,) = _LEN.unpack(header)
  if length > _MAX_MSG:
    raise ValueError(f'message length {length} exceeds bound')
  if crc_ctx is not None:
    crc_ctx.reset()
  if liveness is not None:
    liveness.in_frame = True
  try:
    msg = _recv_msg_body(sock, length, liveness, crc_ctx)
    if crc_ctx is not None:
      trailer = _recv_exact(sock, _CRC.size, liveness)
      if trailer is None:
        raise ConnectionError('EOF mid-message (CRC trailer)')
      crc_ctx.wire = _CRC.unpack(trailer)[0]
    return msg
  finally:
    if liveness is not None:
      liveness.in_frame = False


def _recv_msg_body(sock: socket.socket, length: int, liveness,
                   crc_ctx=None):
  def feed(data):
    if crc_ctx is not None:
      crc_ctx.update(data)
    return data

  tag = _recv_exact(sock, 1, liveness)
  if tag is None:
    raise ConnectionError('EOF mid-message')
  feed(tag)
  kind = tag[0]
  if kind == _FRAME_PLAIN:
    payload = _recv_exact(sock, length - 1, liveness)
    if payload is None:
      raise ConnectionError('EOF mid-message')
    return pickle.loads(memoryview(feed(payload)))
  if kind == _FRAME_OOB:
    head_len = _OOB_META.size
    head = _recv_exact(sock, head_len, liveness)
    if head is None:
      raise ConnectionError('EOF mid-message')
    nbufs, skel_len = _OOB_META.unpack(feed(head))
    # Bound the header's sizes by the frame length before allocating
    # anything sized by them.
    if 1 + head_len + skel_len + _OOB_BUFLEN.size * nbufs > length:
      raise ValueError(
          f'OOB header inconsistent with frame length {length}: '
          f'{nbufs} buffers, skeleton {skel_len}')
    table = _recv_exact(sock, skel_len + _OOB_BUFLEN.size * nbufs,
                        liveness)
    if table is None:
      raise ConnectionError('EOF mid-message')
    view = memoryview(feed(table))
    skeleton = view[:skel_len]
    sizes = [_OOB_BUFLEN.unpack_from(view,
                                     skel_len + _OOB_BUFLEN.size * i)[0]
             for i in range(nbufs)]
    consumed = (1 + head_len + len(table) + sum(sizes))
    if consumed != length:
      raise ValueError(
          f'OOB frame length mismatch: parsed {consumed} of {length}')
    buffers = []
    for size in sizes:
      buf = memoryview(np.empty(int(size), np.uint8))
      if _recv_into(sock, buf, int(size), liveness) < size:
        raise ConnectionError('EOF mid-message')
      buffers.append(feed(buf))
    return pickle.loads(skeleton, buffers=buffers)
  raise ValueError(f'unknown frame kind {kind}')


class LearnerShutdown(Exception):
  """The learner announced a clean shutdown ('bye'): actors exit
  instead of reconnecting."""


class ContractMismatch(RuntimeError):
  """The learner refused this host's handshake: the offered config or
  signature differs from the learner's."""


class ProtocolError(RuntimeError):
  """The peer sent bytes this protocol cannot parse (a version-skewed
  peer). Terminal: retrying the same peer cannot succeed."""


class SessionEpochMismatch(ConnectionError):
  """The learner refused an unroll stamped with a foreign session epoch
  ('stale_epoch'): the learner restarted. A ConnectionError, so the
  reconnect path (a fresh handshake) runs."""


class UnrollCorrupt(RuntimeError):
  """The learner's CRC check refused this unroll ('corrupt'): the
  connection is fine; the pump resends the same unroll, and a repeated
  refusal puts the host on probation, then into quarantine."""

  def __init__(self, message: str, crc: Optional[int] = None):
    super().__init__(message)
    self.crc = crc


class CrcProbation:
  """The client's CRC self-quarantine ladder:

    refusal 1 of an unroll    -> RESEND (at-least-once)
    refusal 2 (same unroll)   -> PROBE, once per run: cool down
                                 `cooldown_secs`, then resend it once
    the probe refused, or a later unroll refused twice once the
    probation is spent        -> QUARANTINE (terminal)
    the probe acked           -> recovered

  Decisions only (no I/O); the pump sleeps and sends."""

  RESEND = 'resend'
  PROBE = 'probe'
  QUARANTINE = 'quarantine'

  def __init__(self, cooldown_secs: float = 30.0):
    self.cooldown_secs = max(float(cooldown_secs), 0.0)
    self.crc_resends = 0
    self.probations = 0
    self.recoveries = 0
    self._probation_used = False
    self._probe_pending = False
    self._resent = False  # the current unroll was resent once

  def next_unroll(self):
    """A new unroll: its resend budget resets (the probation's is per
    run)."""
    self._resent = False

  def on_refusal(self) -> str:
    """The learner's CRC refused the current unroll: what now?"""
    if not self._resent:
      self._resent = True
      self.crc_resends += 1
      return self.RESEND
    if self._probe_pending or self._probation_used:
      self._probe_pending = False
      return self.QUARANTINE
    self._probation_used = True
    self._probe_pending = True
    self.probations += 1
    return self.PROBE

  def on_ack(self) -> bool:
    """An unroll was accepted; True when it was the probation probe."""
    if self._probe_pending:
      self._probe_pending = False
      self.recoveries += 1
      return True
    return False


class ParamsCorrupt(RuntimeError):
  """A fetched snapshot failed its content digest: not installed; the
  caller keeps its params and refetches on backoff."""

  def __init__(self, message: str, version: Optional[int] = None):
    super().__init__(message)
    self.version = version


class Backoff:
  """Capped exponential backoff with full jitter: the n-th delay is
  uniform in [0, min(cap, base * 2**n)], so a fleet of retrying hosts
  does not move in lockstep. Retry loops build a fresh one per
  incident; `rng` is injectable for tests."""

  def __init__(self, base: float = 0.2, cap: float = 5.0, rng=None):
    if base <= 0 or cap <= 0:
      raise ValueError('base and cap must be > 0')
    self._base = base
    self._cap = cap
    self._rng = rng if rng is not None else random
    self._attempt = 0

  @property
  def attempt(self) -> int:
    return self._attempt

  def next_delay(self) -> float:
    ceiling = min(self._cap, self._base * (2 ** self._attempt))
    # The attempt stops growing once the cap binds.
    if self._base * (2 ** self._attempt) < self._cap:
      self._attempt += 1
    return self._rng.uniform(0.0, ceiling)

  def sleep(self) -> float:
    delay = self.next_delay()
    time.sleep(delay)
    return delay

  def reset(self) -> None:
    self._attempt = 0


# The wire protocol's version, and the versions a handshake accepts.
# What each version adds, negotiated off per connection for older peers:
#   5  the param lane ('hello_params'); 'unroll' frames may carry the
#      client's params version (3rd element) for the staleness window,
#      answered ('stale', current) when too old.
#   6  params replies carry a 4th element, the server-info dict
#      (protocol, session_epoch, heartbeat_secs, idle_timeout_secs);
#      'hello' may carry a 3rd, the client-info dict ({'epoch'}: the
#      prior epoch of a reattaching client); 'ping' -> ('pong', version);
#      ('busy',) keepalives while backpressure holds an ack; 'unroll'
#      frames may carry the session epoch (4th), refused with
#      ('stale_epoch', epoch) when foreign.
#   7  CRC32C trailers on every frame both ways once client-info
#      {'crc', 'crc_algo'} and the server's wire_crc agree (algorithms
#      must match); ('corrupt', crc) refusals; the server-info's
#      'params_digest', and a {'digest_rejected': version} notice on
#      the client's next get_params.
#   8  the server-info's 'trace' flag; 'unroll' frames then carry the
#      trace context (5th, with an optional 'pi' install notice);
#      'stats' -> ('stats', {...}).
#   9  client-info 'host' (the membership ledger); 'leave' ->
#      ('bye_ack',).
#  10  'params_int8' blobs for v10 subscribers ('hello_params' info
#      carries 'protocol'); 'infer' -> ('infer_ok', result, notice) or
#      ('error', ...).
PROTOCOL_VERSION = 10
_COMPATIBLE_PROTOCOLS = (5, 6, 7, 8, 9, 10)

# Bound on the reader -> worker handoff queue: a peer pipelining unrolls
# without awaiting acks blocks its own reader instead of growing it.
_INGEST_QUEUE_DEPTH = 256


def _is_signature_leaf(x) -> bool:
  """A signature tree's leaves are (shape tuple, dtype name) pairs."""
  return (isinstance(x, tuple) and len(x) == 2
          and isinstance(x[1], str))


def _flatten_with_path(tree, is_leaf=None) -> List[Tuple[str, object]]:
  """[(key path, leaf)] of a nest of NamedTuples, tuples, lists and
  dicts in JAX's flatten order, the paths spelled as JAX's `keystr`
  spells them (`.agent_state[0]`, `['w']`); None has no leaves."""
  out = []

  def visit(x, path):
    if is_leaf is not None and is_leaf(x):
      out.append((path, x))
    elif x is None:
      return
    elif isinstance(x, tuple) and hasattr(x, '_fields'):
      for name, child in zip(x._fields, x):
        visit(child, f'{path}.{name}')
    elif isinstance(x, (tuple, list)):
      for i, child in enumerate(x):
        visit(child, f'{path}[{i}]')
    elif isinstance(x, dict):
      for key in sorted(x):
        visit(x[key], f'{path}[{key!r}]')
    else:
      out.append((path, x))
  visit(tree, '')
  return out


def _treedef(tree, is_leaf=None):
  """A comparable structure of `tree`: node types and child structure,
  '*' for a leaf (JAX's treedef equality)."""
  if is_leaf is not None and is_leaf(tree):
    return '*'
  if tree is None:
    return None
  if isinstance(tree, (tuple, list)):
    return (type(tree), tuple(_treedef(c, is_leaf) for c in tree))
  if isinstance(tree, dict):
    return (dict, tuple((k, _treedef(tree[k], is_leaf))
                        for k in sorted(tree)))
  return '*'


def _dtype_name(x) -> str:
  """numpy's dtype name of an array or a torch tensor."""
  dtype = getattr(x, 'dtype', None)
  if dtype is not None and not isinstance(dtype, np.dtype):
    return str(dtype).replace('torch.', '')
  return np.asarray(x).dtype.name


def trajectory_contract(config, agent, num_actions: int):
  """The wire contract both roles derive from their own config: the
  config fields the trajectory's meaning depends on, and the
  shape/dtype signature of one unroll. The server compares the offered
  contract at 'hello' and refuses a mismatch naming the fields; each
  received unroll is then validated against the signature before it can
  reach the buffer. `fields` carries knobs that change no shape too
  (num_action_repeats, torso, compute_dtype, ...), so a skew fails at
  connect. `signature` is keyed by JAX's keystr paths and equals the JAX
  package's contract of the same config; `signature_tree` holds the same
  leaves as a nest, for the per-connection fast validator."""
  from scalable_agent_tpu_torch.envs import factory
  from scalable_agent_tpu_torch.models.instruction import (
      MAX_INSTRUCTION_LEN)
  from scalable_agent_tpu_torch.structs import (
      ActorOutput, AgentOutput, StepOutput, StepOutputInfo)

  t1 = config.unroll_length + 1
  h, w = config.height, config.width

  def leaf(shape, dtype):
    return (tuple(int(s) for s in shape), np.dtype(dtype).name)

  # The carry an actor ships is agent.initial_state(1)-shaped; the heads
  # are float32 by the model's contract.
  state_sig = tuple((tuple(int(s) for s in x.shape), _dtype_name(x))
                    for x in agent.initial_state(1))
  example = ActorOutput(
      level_name=leaf((), np.int32),
      agent_state=state_sig,
      env_outputs=StepOutput(
          reward=leaf((t1,), np.float32),
          info=StepOutputInfo(
              episode_return=leaf((t1,), np.float32),
              episode_step=leaf((t1,), np.int32)),
          done=leaf((t1,), np.bool_),
          observation=(leaf((t1, h, w, 3), np.uint8),
                       leaf((t1, MAX_INSTRUCTION_LEN), np.int32))),
      agent_outputs=AgentOutput(
          action=leaf((t1,), np.int32),
          policy_logits=leaf((t1, int(num_actions)), np.float32),
          baseline=leaf((t1,), np.float32)))
  signature = dict(_flatten_with_path(example,
                                      is_leaf=_is_signature_leaf))
  fields = {
      'env_backend': config.env_backend,
      # Unroll level ids index the learner's level list (and PopArt's
      # per-task statistics) by position, and are range-checked.
      'level_name': config.level_name,
      'num_levels': len(factory.level_names(config)),
      'height': int(config.height),
      'width': int(config.width),
      'unroll_length': int(config.unroll_length),
      'num_actions': int(num_actions),
      'num_action_repeats': int(config.num_action_repeats),
      'use_instruction': bool(config.resolved_use_instruction),
      'torso': config.torso,
      'compute_dtype': config.compute_dtype,
      'sticky_action_prob': float(config.sticky_action_prob),
      'episode_length': int(config.episode_length),
      'use_popart': bool(config.use_popart),
      'pixel_control_cost': float(config.pixel_control_cost),
  }
  return {'protocol': PROTOCOL_VERSION, 'fields': fields,
          'signature': signature, 'signature_tree': example}


def contract_mismatch_message(expected, offered) -> Optional[str]:
  """The difference of two contracts naming every offending field and
  leaf, or None when they agree. Any protocol in
  _COMPATIBLE_PROTOCOLS handshakes."""
  if offered is None:
    return ('actor sent a legacy hello with no contract (protocol < '
            f'{PROTOCOL_VERSION}); upgrade the actor host')
  problems = []
  offered_protocol = offered.get('protocol')
  if (offered_protocol != expected['protocol']
      and offered_protocol not in _COMPATIBLE_PROTOCOLS):
    problems.append(f"protocol: learner={expected['protocol']} "
                    f"actor={offered_protocol}")
  for key in sorted(set(expected['fields']) |
                    set(offered.get('fields', {}))):
    e = expected['fields'].get(key, '<missing>')
    o = offered.get('fields', {}).get(key, '<missing>')
    if e != o:
      problems.append(f'config.{key}: learner={e!r} actor={o!r}')
  exp_sig = expected['signature']
  off_sig = offered.get('signature', {})
  for key in sorted(set(exp_sig) | set(off_sig)):
    e, o = exp_sig.get(key), off_sig.get(key)
    if e != o:
      problems.append(f'unroll{key}: learner={e} actor={o}')
  if not problems:
    return None
  return ('config/signature mismatch between learner and actor host: '
          + '; '.join(problems))


def _value_violations(unroll, fields) -> List[str]:
  """Range checks of a structurally valid unroll: actions (the
  learner's bincount) and level ids (a negative id aliases another
  level's statistics)."""
  problems = []
  num_actions = fields['num_actions']
  actions = np.asarray(unroll.agent_outputs.action)
  if actions.size and (actions.min() < 0 or
                       actions.max() >= num_actions):
    problems.append(
        f'actions out of range [0, {num_actions}): '
        f'min={actions.min()} max={actions.max()}')
  num_levels = fields.get('num_levels')
  if num_levels is not None:
    level = int(np.asarray(unroll.level_name))
    if not 0 <= level < num_levels:
      problems.append(
          f'level_name {level} out of range [0, {num_levels})')
  return problems


def unroll_violations(unroll, contract) -> List[str]:
  """Validate one received unroll's leaves against the agreed signature,
  then its action and level ranges. Returns the problems ([] = clean).
  The slow, leaf-naming path: the server runs `FastUnrollValidator`
  and comes here only to name what failed."""
  signature = contract['signature']
  try:
    got = {p: (tuple(np.shape(x)), np.asarray(x).dtype.name)
           for p, x in _flatten_with_path(unroll)}
  except Exception as e:  # not even a nest of arrays
    return [f'unroll is not a valid trajectory pytree: {e!r}']
  problems = []
  for key in sorted(set(signature) | set(got)):
    e, o = signature.get(key), got.get(key)
    if e is None:
      problems.append(f'unexpected leaf unroll{key}={o}')
    elif o is None:
      problems.append(f'missing leaf unroll{key} (expected {e})')
    elif e != o:
      problems.append(f'unroll{key}: expected {e}, got {o}')
  if not problems:
    problems = _value_violations(unroll, contract['fields'])
  return problems


class FastUnrollValidator:
  """Per-connection validation with the structure and the flat
  (shape, dtype) list computed once: each unroll costs one flatten and
  a leaf-by-leaf compare. Any failure falls back to `unroll_violations`
  for the leaf-naming message. A contract without `signature_tree`
  (an old peer) always takes the slow path."""

  def __init__(self, contract):
    self._contract = contract
    self._fast = None
    tree = contract.get('signature_tree')
    if tree is not None:
      self._fast = (_treedef(tree, _is_signature_leaf),
                    [leaf for _, leaf in _flatten_with_path(
                        tree, is_leaf=_is_signature_leaf)])

  def __call__(self, unroll) -> List[str]:
    if self._fast is None:
      return unroll_violations(unroll, self._contract)
    treedef, expected = self._fast
    try:
      if _treedef(unroll) == treedef:
        leaves = [x for _, x in _flatten_with_path(unroll)]
        for (eshape, edtype), x in zip(expected, leaves):
          if (np.shape(x) != eshape
              or np.asarray(x).dtype.name != edtype):
            break
        else:
          return _value_violations(unroll, self._contract['fields'])
    except Exception:
      pass  # the slow path names the problem
    return unroll_violations(unroll, self._contract)


class _Conn:
  """One actor connection: the socket and a send lock (workers and
  close()'s 'bye' must not interleave writes). `last_recv` is the
  reaper's idle clock; `protocol`/`heartbeat`/`crc` are negotiated at
  hello; `reaped` marks a reaper-initiated close; `inflight` counts
  unrolls handed to the workers whose reply has not gone out (the
  lockstep peer is silent by protocol meanwhile, so the reaper exempts
  it). With `send_stall_secs` every send is progress-bounded."""

  inflight: guarded_by('inflight_lock')

  def __init__(self, sock: socket.socket, addr=None,
               send_stall_secs: Optional[float] = None,
               base_timeout: Optional[float] = None):
    self.sock = sock
    self.addr = addr
    self.send_lock = make_lock('remote._Conn.send_lock')
    self.send_stall_secs = send_stall_secs
    # The socket timeout try_send restores (None: blocking mode; the
    # reader's poll interval in liveness mode).
    self.base_timeout = base_timeout
    self.unrolls = 0
    self.stale_rejected = 0
    self.last_recv = time.monotonic()
    self.protocol = 5          # until a hello says otherwise
    self.heartbeat = False     # negotiated: a v6 peer and heartbeats on
    self.hb_missed = False     # the current silence was counted
    self.reaped = False        # reaper-initiated close in progress
    # CRC trailers both ways, negotiated at hello (the hello reply
    # itself ships per the prior state).
    self.crc = False
    self.crc_rejected = 0
    # Membership: the hello's host identity (None for a pre-v9 peer),
    # and whether a 'leave' announced a deliberate drain.
    self.host_id = None
    self.draining = False
    self.inflight = 0
    self.inflight_lock = make_lock('remote._Conn.inflight_lock')

  def job_started(self):
    with self.inflight_lock:
      self.inflight += 1

  def job_finished(self):
    with self.inflight_lock:
      self.inflight -= 1

  def is_waiting_on_us(self) -> bool:
    with self.inflight_lock:
      return self.inflight > 0

  def _write(self, data) -> None:
    """One bounded (or blocking) write; callers hold send_lock."""
    if self.send_stall_secs is not None:
      _sendall_bounded(self.sock, data, self.send_stall_secs)
    else:
      self.sock.sendall(data)

  def send(self, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with self.send_lock:
      self._write(_plain_frame(payload, crc=self.crc))

  def send_bytes(self, payload: bytes) -> None:
    """Ship pre-pickled bytes as a plain frame."""
    with self.send_lock:
      self._write(_plain_frame(payload, crc=self.crc))

  def send_segments(self, segments,
                    trailer: Optional[bytes] = None) -> None:
    """Ship a pre-built frame's segments unjoined; `trailer` only when
    this send carries one."""
    with self.send_lock:
      for seg in segments:
        self._write(seg)
      if trailer is not None:
        self._write(trailer)

  def send_oob(self, obj) -> None:
    """Ship `obj` as an OOB frame (the 'infer' reply), with the trailer
    when this connection negotiated CRC."""
    segments = _oob_frame_segments(obj)
    trailer = (_CRC.pack(_segments_crc(segments))
               if self.crc else None)
    self.send_segments(segments, trailer)

  def try_send(self, obj, timeout: float = 2.0) -> bool:
    """Bounded best-effort send: shutdown never blocks behind a stuck
    peer."""
    if not self.send_lock.acquire(timeout=timeout):
      return False
    try:
      self.sock.settimeout(timeout)
      _send_msg(self.sock, obj, crc=self.crc)
      return True
    except OSError:
      return False
    finally:
      try:
        self.sock.settimeout(self.base_timeout)
      except OSError:
        pass
      self.send_lock.release()


class _ParamLane:
  """The weight fan-out: every 'hello_params' subscriber socket,
  multiplexed by one selector thread with chunked non-blocking sends, so
  the blob plane is one runnable thread with bounded writes however many
  hosts subscribe, and acks never wait behind a blob. Requests are tiny
  frames; replies are the server's cached blob of the current version
  (`blob_fn(subscriber protocol) -> (segments, trailer)`)."""

  def __init__(self, blob_fn, chunk_bytes: int = 128 * 1024,
               idle_timeout_secs: float = 0.0,
               watchdog: Optional[ThreadWatchdog] = None):
    self._blob_fn = blob_fn
    self._chunk = chunk_bytes
    self._idle_timeout = float(idle_timeout_secs)
    self._watchdog = watchdog
    self._selector = selectors.DefaultSelector()
    self._lock = make_lock('remote._ParamLane._lock')  # adopt vs close
    self._closed = False
    self._blobs_served = 0
    self._bytes_sent = 0
    self._subs_dropped = 0  # every dropped subscriber
    self._subs_reaped = 0   # the idle ones among them
    # Digest-rejected notices riding subscribers' retry fetches, and
    # requests whose own trailer failed (the subscriber is dropped).
    self._digest_rejected = 0
    self._req_crc_dropped = 0
    # Self-pipe: adopt() and close() wake a parked select().
    self._wake_r, self._wake_w = socket.socketpair()
    self._wake_r.setblocking(False)
    self._selector.register(self._wake_r, selectors.EVENT_READ, None)
    self._pending_adopts: List = []
    self._thread = threading.Thread(target=self._loop,
                                    name='param-lane', daemon=True)
    self._thread.start()

  class _Sub:
    """One subscriber: its request parse buffer and outgoing chunks."""

    def __init__(self, sock, crc: bool = False, proto: int = 5):
      self.sock = sock
      self.crc = crc  # trailers on replies, verified on requests
      self.proto = proto  # picks the cached blob encoding
      self.rbuf = bytearray()
      self.out: List[memoryview] = []
      self.last_recv = time.monotonic()

  def adopt(self, sock: socket.socket, crc: bool = False,
            proto: int = 5) -> bool:
    """Hand a connected socket to the lane (the peer said
    'hello_params'); False when closing."""
    with self._lock:
      if self._closed:
        return False
      self._pending_adopts.append((sock, crc, proto))
    try:
      self._wake_w.send(b'x')
    except OSError:
      pass
    return True

  def stats(self):
    with self._lock:
      return {'blobs': self._blobs_served, 'bytes': self._bytes_sent,
              'subs_dropped': self._subs_dropped,
              'subs_reaped': self._subs_reaped,
              'digest_rejected': self._digest_rejected,
              'req_crc_dropped': self._req_crc_dropped}

  def _drop(self, sub, reaped: bool = False):
    with self._lock:
      self._subs_dropped += 1
      if reaped:
        self._subs_reaped += 1
    try:
      self._selector.unregister(sub.sock)
    except (KeyError, ValueError):
      pass
    sub.sock.close()

  def _queue_segments(self, sub, segments):
    sub.out.extend(memoryview(s) for s in segments)
    self._selector.modify(sub.sock,
                          selectors.EVENT_READ | selectors.EVENT_WRITE,
                          sub)

  def _queue_reply(self, sub, payload: bytes):
    header = _LEN.pack(len(payload) + 1) + bytes((_FRAME_PLAIN,))
    if sub.crc:
      self._queue_segments(sub, (header, payload, _CRC.pack(
          integrity.crc_bytes(payload, integrity.crc_bytes(
              bytes((_FRAME_PLAIN,)))))))
    else:
      self._queue_segments(sub, (header, payload))

  def _on_readable(self, sub) -> bool:
    """Drain request bytes; False = the subscriber is gone."""
    try:
      data = sub.sock.recv(4096)
    except BlockingIOError:
      return True
    except OSError:
      return False
    if not data:
      return False
    sub.last_recv = time.monotonic()
    sub.rbuf += data
    while True:
      if len(sub.rbuf) < _LEN.size:
        return True
      (length,) = _LEN.unpack_from(sub.rbuf)
      if length > 1 << 20:  # param requests are tiny frames
        log.warning('param lane: oversized request frame (%d bytes); '
                    'dropping subscriber', length)
        return False
      want = _LEN.size + length + (_CRC.size if sub.crc else 0)
      if len(sub.rbuf) < want:
        return True
      frame = bytes(sub.rbuf[_LEN.size:_LEN.size + length])
      if sub.crc:
        (wire_crc,) = _CRC.unpack_from(sub.rbuf, _LEN.size + length)
        if wire_crc != integrity.crc_bytes(frame):
          with self._lock:
            self._req_crc_dropped += 1
          log.warning('param lane: request failed its CRC trailer; '
                      'dropping subscriber')
          return False
      del sub.rbuf[:want]
      try:
        if frame[0] != _FRAME_PLAIN:
          raise ValueError(f'unexpected frame kind {frame[0]}')
        msg = pickle.loads(frame[1:])
        kind = msg[0]
      except Exception as e:  # a version-skewed peer: drop just it
        log.warning('param lane: unparseable request (%r); dropping '
                    'subscriber', e)
        return False
      if kind in ('get_params', 'hello_params', 'ping'):
        # A pipelined hello_params needs no reply, but its info dict
        # still sets the subscriber's CRC and protocol.
        if kind == 'hello_params' and len(msg) > 1 and \
            isinstance(msg[1], dict):
          sub.crc = bool(msg[1].get('crc')) and \
              msg[1].get('crc_algo') == integrity.CRC_ALGO
          sub.proto = int(msg[1].get('protocol') or sub.proto)
        if kind == 'get_params':
          if len(msg) > 1 and isinstance(msg[1], dict) and \
              msg[1].get('digest_rejected') is not None:
            with self._lock:
              self._digest_rejected += 1
            log.error(
                'param lane: subscriber refused params v%s — content '
                'digest mismatch (corrupt publish); it keeps its '
                'prior snapshot and refetches on backoff',
                msg[1]['digest_rejected'])
          with self._lock:
            self._blobs_served += 1
          segments, trailer = self._blob_fn(sub.proto)
          self._queue_segments(
              sub, tuple(segments) + ((trailer,) if sub.crc else ()))
        elif kind == 'ping':
          self._queue_reply(sub, pickle.dumps(
              ('pong',), protocol=pickle.HIGHEST_PROTOCOL))
      else:
        self._queue_reply(sub, pickle.dumps(
            ('error', f'param lane only serves get_params, got '
             f'{kind!r}'), protocol=pickle.HIGHEST_PROTOCOL))
    return True

  def _on_writable(self, sub) -> bool:
    """Send at most one chunk; False = the subscriber is gone."""
    while sub.out:
      view = sub.out[0]
      try:
        sent = sub.sock.send(view[:self._chunk])
      except BlockingIOError:
        return True
      except OSError:
        return False
      with self._lock:
        self._bytes_sent += sent
      if sent < len(view):
        sub.out[0] = view[sent:]
      else:
        sub.out.pop(0)
      # One bounded write per poll round: fairness across subscribers.
      return True
    self._selector.modify(sub.sock, selectors.EVENT_READ, sub)
    return True

  def _loop(self):
    try:
      self._loop_body()
    except Exception:
      log.exception('param lane died; subscribers will see drops')

  def _loop_body(self):
    while True:
      if self._watchdog is not None:
        self._watchdog.beat('param-lane')
      with self._lock:
        if self._closed:
          return
        adopts, self._pending_adopts = self._pending_adopts, []
      for sock, crc, proto in adopts:
        sock.setblocking(False)
        try:
          self._selector.register(sock, selectors.EVENT_READ,
                                  self._Sub(sock, crc=crc, proto=proto))
        except (KeyError, ValueError, OSError):
          sock.close()
      # Idle reaping, on this thread (the selector is never mutated
      # elsewhere); a subscriber mid-reply is left alone.
      if self._idle_timeout > 0:
        cutoff = time.monotonic() - self._idle_timeout
        stale = [key.data for key in self._selector.get_map().values()
                 if key.data is not None and not key.data.out
                 and key.data.last_recv < cutoff]
        for sub in stale:
          log.warning('param lane: reaping idle subscriber (silent '
                      'for > %.1fs)', self._idle_timeout)
          self._drop(sub, reaped=True)
      for key, events in self._selector.select(timeout=0.5):
        if key.data is None:  # the wake pipe
          try:
            self._wake_r.recv(4096)
          except OSError:
            pass
          continue
        sub = key.data
        ok = True
        if events & selectors.EVENT_READ:
          ok = self._on_readable(sub)
        if ok and events & selectors.EVENT_WRITE:
          ok = self._on_writable(sub)
        if not ok:
          self._drop(sub)

  def close(self, graceful: bool = True) -> int:
    """Shut the lane down; returns 1 when the selector thread missed
    its join deadline (it then leaks with its sockets), else 0.
    graceful=True answers every subscriber with no reply in progress
    with ('bye',) first."""
    with self._lock:
      if self._closed:
        return 0
      self._closed = True
    try:
      self._wake_w.send(b'x')
    except OSError:
      pass
    self._thread.join(timeout=5.0)
    unjoined = 1 if self._thread.is_alive() else 0
    if unjoined:
      log.warning('param lane close: selector thread missed the join '
                  'deadline and leaks as a daemon (selector/sockets '
                  'leaked with it)')
      return unjoined
    if graceful:
      bye = pickle.dumps(('bye',), protocol=pickle.HIGHEST_PROTOCOL)
      frame = (_LEN.pack(len(bye) + 1) + bytes((_FRAME_PLAIN,)) + bye)
      frame_crc = frame + _CRC.pack(
          integrity.crc_bytes(frame[_LEN.size:]))
      for key in list(self._selector.get_map().values()):
        # Not where a chunked reply is half sent: the bye would land
        # mid-message.
        if key.data is not None and not key.data.out:
          try:
            key.fileobj.send(frame_crc if key.data.crc else frame)
          except OSError:
            pass
    for key in list(self._selector.get_map().values()):
      if key.data is not None:
        key.fileobj.close()
    self._selector.close()
    self._wake_r.close()
    self._wake_w.close()
    if self._watchdog is not None:
      self._watchdog.unregister('param-lane')
    return unjoined


def _wire_digest(tree) -> int:
  """The content digest of a wire-form snapshot: integrity.tree_digest's
  stream over `codec.wire_leaves`, a Bf16Leaf's bits under the dtype
  name 'bfloat16', so it equals the JAX package's digest of the same
  tree (its bfloat16 leaves are ml_dtypes arrays)."""
  integrity.count_tree_digest()
  crc = integrity.Crc()

  def one(arr, name):
    crc.update(f'{name}:{arr.shape};'.encode())
    if not arr.flags['C_CONTIGUOUS']:
      arr = np.ascontiguousarray(arr)
    crc.update(arr.reshape(-1).view(np.uint8))

  def visit(x):
    if isinstance(x, dict):
      for key in sorted(x):
        visit(x[key])
    elif isinstance(x, (tuple, list)):
      for child in x:
        visit(child)
    elif isinstance(x, codec_lib.Int8Leaf):
      visit(x.q)
      visit(x.scale)
    elif isinstance(x, codec_lib.Bf16Leaf):
      one(np.asarray(x.bits, np.uint16), 'bfloat16')
    elif x is not None:
      arr = np.asarray(x)
      one(arr, arr.dtype.name)
  visit(tree)
  return crc.value


class TrajectoryIngestServer:
  """Learner side: accepts remote-actor connections, lands their unrolls
  in the shared TrajectoryBuffer, serves param snapshots.

  Args:
    buffer: the learner's TrajectoryBuffer (shared with a local fleet).
    params: the initial host param tree (numpy leaves), version 1.
    host/port: the bind address; port 0 picks a free port (`.port`).
      Loopback by default: the wire is unauthenticated pickle.
    contract: `trajectory_contract(...)` of the learner's config. When
      given, a client must open with a matching 'hello' before any
      unroll is accepted, and every unroll is validated against the
      signature before the buffer sees it. None disables both.
    wire_dtype: 'bfloat16' ships float32 leaves as bfloat16 (kind
      'params_bf16', the client upcasts); 'int8' ships absmax int8 to
      v10 subscribers ('params_int8') and bfloat16 to older ones;
      ''/None exact float32.
    ingest_workers: the validate/commit pool's size (0 = min(4, cpus)).
    max_unroll_staleness: admit an unroll only when the client's params
      version is within this many published versions of the current one
      (0 = no window); a stale one gets ('stale', current_version).
    heartbeat_secs: the liveness cadence: v6 clients ping when idle,
      readers send ('busy',) while backpressure holds an ack. 0 = off.
    idle_timeout_secs: a connection on either lane that received nothing
      for this long is reaped; it is also the mid-frame receive and the
      send no-progress deadline. 0 = no reaping, no deadlines.
    wire_crc: offer CRC32C trailers to v7 clients at hello; a
      mismatched unroll is refused with ('corrupt', crc) before the put.
    trace: advertise tracing, so v8 clients stamp trace contexts.
  """

  # Three locks, never nested: the published snapshot under
  # _params_lock, the connection counters under _stats_lock, the live
  # connection and thread lists under _conns_lock.
  _version: guarded_by('_params_lock')
  _blob_version: guarded_by('_params_lock')
  _params_frame: guarded_by('_params_lock')
  _params_frame_compat: guarded_by('_params_lock')
  _serving_fn: guarded_by('_params_lock')
  _draining: guarded_by('_params_lock')
  _serializations: guarded_by('_params_lock')
  _connections: guarded_by('_stats_lock')
  _param_subscribers: guarded_by('_stats_lock')
  _reattached: guarded_by('_stats_lock')
  _reconnected: guarded_by('_stats_lock')
  _reattach_latency: guarded_by('_stats_lock')
  _unjoined_threads: guarded_by('_stats_lock')
  _threads: guarded_by('_conns_lock')
  _conns: guarded_by('_conns_lock')
  _members: guarded_by('_conns_lock')
  _member_events: guarded_by('_conns_lock')

  def __init__(self, buffer, params, host: str = '127.0.0.1',
               port: int = 0, contract=None,
               wire_dtype: Optional[str] = None,
               ingest_workers: int = 0,
               max_unroll_staleness: int = 0,
               heartbeat_secs: float = 0.0,
               idle_timeout_secs: float = 0.0,
               wire_crc: bool = True,
               trace: bool = True):
    if wire_dtype not in (None, '', 'bfloat16', 'int8'):
      raise ValueError(f'unsupported wire_dtype {wire_dtype!r}')
    self._wire_bf16 = wire_dtype == 'bfloat16'
    # Under int8 each publish builds two blobs: int8 for v10
    # subscribers, bfloat16 for older ones.
    self._wire_int8 = wire_dtype == 'int8'
    self._wire_crc = bool(wire_crc)
    self._trace = bool(trace)
    self._buffer = buffer
    self._contract = contract
    self._max_staleness = int(max_unroll_staleness)
    self._validate = (FastUnrollValidator(contract)
                      if contract is not None else None)
    # The session epoch: wall-clock microseconds and the pid, unique
    # across restarts on one port without any state on disk.
    self.session_epoch = ((int(time.time() * 1e6) << 10)
                          ^ (os.getpid() & 0x3ff))
    self._t_start = time.monotonic()
    self._heartbeat_secs = float(heartbeat_secs)
    self._idle_timeout = float(idle_timeout_secs)
    self._liveness_on = (self._heartbeat_secs > 0
                         or self._idle_timeout > 0)
    # The mid-frame and send stall deadline.
    self._stall_secs = (self._idle_timeout if self._idle_timeout > 0
                        else max(3 * self._heartbeat_secs, 10.0))
    polls = [1.0]
    if self._idle_timeout > 0:
      polls.append(self._idle_timeout / 4)
    if self._heartbeat_secs > 0:
      polls.append(self._heartbeat_secs / 2)
    self._poll_secs = max(min(polls), 0.05)
    self._watchdog = ThreadWatchdog()
    self._params_lock = make_lock('remote.IngestServer._params_lock')
    self._version = 1
    self._blob_version = 1
    # One serialization per version: readers and the lane ship these
    # cached frames.
    self._serializations = 0
    self._params_frame = self._make_blob(self._version, params)
    self._params_frame_compat = (
        self._make_blob(self._version, params, compat=True)
        if self._wire_int8 else None)
    # Routed inference: 'infer' answers ('error', ...) until
    # attach_serving; set_draining flips the notice routers read.
    self._serving_fn = None
    self._draining = False
    self._stats_lock = make_lock('remote.IngestServer._stats_lock')
    self._unrolls = telemetry.counter('ingest/unrolls')
    self._rejected = telemetry.counter('ingest/rejected')
    self._stale_rejected = telemetry.counter('ingest/stale_rejected')
    self._quarantined = telemetry.counter('ingest/quarantined')
    self._wire_crc_rejected = telemetry.counter(
        'ingest/wire_crc_rejected')
    self._discarded_frames = telemetry.counter(
        'ingest/discarded_frames')
    self._discarded_bytes = telemetry.counter(
        'ingest/discarded_bytes')
    self._connections = 0
    self._param_subscribers = 0  # cumulative hello_params adoptions
    self._conns_reaped = telemetry.counter('ingest/conns_reaped')
    self._heartbeat_misses = telemetry.counter(
        'ingest/heartbeat_misses')
    self._stale_epoch_rejected = telemetry.counter(
        'ingest/stale_epoch_rejected')
    self._reattached = 0         # hellos carrying a foreign prior epoch
    self._reconnected = 0        # hellos carrying this epoch
    self._reattach_latency = 0.0  # the last reattach, secs after start
    self._unjoined_threads = 0   # close()'s join-deadline misses
    self._ack_hist = telemetry.histogram('ingest/ack_ms')
    self._closed = threading.Event()
    self._threads: List[threading.Thread] = []
    self._conns: List[_Conn] = []
    # Membership: host identity -> the connection carrying it, and the
    # join/leave events the driver drains into incidents.
    self._members: Dict[str, _Conn] = {}
    self._member_events: List[Dict] = []
    self._hosts_joined = telemetry.counter('ingest/hosts_joined')
    self._hosts_left = telemetry.counter('ingest/hosts_left')
    self._conns_lock = make_lock('remote.IngestServer._conns_lock')
    # Readers push (conn, unroll, t_recv, client_version, client_epoch,
    # crc_pair, trace); the workers validate, put (the backpressure)
    # and ack.
    self._ingest_q: 'queue.Queue' = queue.Queue(
        maxsize=_INGEST_QUEUE_DEPTH)
    if ingest_workers <= 0:
      ingest_workers = max(1, min(4, os.cpu_count() or 1))
    self._workers = [
        threading.Thread(target=self._ingest_worker,
                         args=(f'ingest-worker-{i}',),
                         name=f'ingest-worker-{i}', daemon=True)
        for i in range(ingest_workers)]
    for w in self._workers:
      w.start()
    self._param_lane = _ParamLane(self._snapshot_frame,
                                  idle_timeout_secs=self._idle_timeout,
                                  watchdog=self._watchdog)
    self._listener = socket.create_server((host, port))
    self.port = self._listener.getsockname()[1]
    self._accept_thread = threading.Thread(
        target=self._accept_loop, name='ingest-accept', daemon=True)
    self._accept_thread.start()
    # The reaper owns the between-frames idle budget: it closes a
    # silent peer's socket, which wakes its reader with an OSError.
    self._reaper_thread = None
    if self._idle_timeout > 0:
      self._reaper_thread = threading.Thread(
          target=self._reap_loop, name='ingest-reaper', daemon=True)
      self._reaper_thread.start()

  def _make_blob(self, version, params,
                 compat: bool = False) -> Tuple[List, bytes]:
    """One published version as (OOB frame segments, CRC trailer): the
    frame is the arrays, so neither side copies them through the
    pickler, and the trailer is computed once per publish. The info
    dict carries 'params_digest', the content digest of the wire form
    (after the bfloat16 cast or the int8 quantization), made before the
    publish_corrupt fault site runs, so a corrupted blob is
    self-consistent on the wire and only the client's digest check can
    see it. `compat=True` builds the bfloat16 blob of an int8 publisher
    for v<=9 subscribers; it does not count as a serialization."""
    if not compat:
      with self._params_lock:
        self._serializations += 1  # once per version
    wire_int8 = self._wire_int8 and not compat
    wire_bf16 = self._wire_bf16 or (self._wire_int8 and compat)
    if wire_int8:
      params = codec_lib.quantize_np(params)
    elif wire_bf16:
      params = codec_lib.to_bf16_np(params)
    digest = _wire_digest(params)
    plan = faults_lib.active()
    fault = faults_lib.fire('publish_corrupt')
    if fault is not None:
      params = faults_lib.corrupt_params_tree(
          fault, params, seed=plan.seed if plan else 0)
    # Server-wide facts: each side derives the same per-connection CRC
    # and trace negotiation from them.
    info = {'protocol': PROTOCOL_VERSION,
            'session_epoch': self.session_epoch,
            'heartbeat_secs': self._heartbeat_secs,
            'idle_timeout_secs': self._idle_timeout,
            'wire_crc': self._wire_crc,
            'crc_algo': integrity.CRC_ALGO,
            'trace': self._trace,
            'params_digest': integrity.digest_record(digest)}
    if wire_int8:
      kind = 'params_int8'
    elif wire_bf16:
      kind = 'params_bf16'
    else:
      kind = 'params'
    segments = _oob_frame_segments((kind, version, params, info))
    return segments, _CRC.pack(_segments_crc(segments))

  def publish_params(self, params) -> int:
    """Swap in a new host param snapshot (numpy leaves); returns its
    version. Serializes once, on the caller's thread, outside the lock;
    the swap is version-guarded, so a slow build of version N never
    overwrites version N+1's blob."""
    with self._params_lock:
      self._version += 1
      version = self._version
    blob = self._make_blob(version, params)
    compat = (self._make_blob(version, params, compat=True)
              if self._wire_int8 else None)
    with self._params_lock:
      if version > self._blob_version:
        self._params_frame = blob
        self._params_frame_compat = compat
        self._blob_version = version
    return version

  @property
  def serializations(self) -> int:
    """Snapshots serialized (the versions published, whatever the
    client count)."""
    with self._params_lock:
      return self._serializations

  def live_hosts(self) -> int:
    """Hosts in the membership ledger (v9 peers only)."""
    with self._conns_lock:
      return len(self._members)

  def membership(self) -> List[str]:
    """Sorted host identities currently attached."""
    with self._conns_lock:
      return sorted(self._members)

  def drain_membership_events(self) -> List[Dict]:
    """Pop the pending join/leave events, oldest first (each delivered
    once)."""
    with self._conns_lock:
      events, self._member_events = self._member_events, []
    return events

  def stats(self):
    with self._conns_lock:
      live = len(self._conns)
      live_hosts = len(self._members)
      per_conn = {f'{c.addr}': c.unrolls for c in self._conns}
      per_conn_stale = {f'{c.addr}': c.stale_rejected
                        for c in self._conns if c.stale_rejected}
    lane = self._param_lane.stats()
    wedged = self._wedged_threads()
    p50, p99 = self._ack_hist.percentiles(0.5, 0.99)
    ack_p50_ms, ack_p99_ms = round(p50, 3), round(p99, 3)
    with self._stats_lock:
      return {'unrolls': self._unrolls.value,
              'rejected': self._rejected.value,
              'stale_rejected': self._stale_rejected.value,
              'per_conn_stale_rejected': per_conn_stale,
              # Connections dropped after an unparseable frame.
              'quarantined': self._quarantined.value,
              'wire_crc_rejected': self._wire_crc_rejected.value,
              'publish_digest_rejected': lane['digest_rejected'],
              'discarded_frames': self._discarded_frames.value,
              'discarded_bytes': self._discarded_bytes.value,
              'connections': self._connections,  # cumulative
              'live': live,
              'live_hosts': live_hosts,
              'hosts_joined': self._hosts_joined.value,
              'hosts_left': self._hosts_left.value,
              'per_conn_unrolls': per_conn,
              'ack_p50_ms': ack_p50_ms,
              'ack_p99_ms': ack_p99_ms,
              'param_blobs': lane['blobs'],
              'param_bytes': lane['bytes'],
              'param_subscribers': self._param_subscribers,
              'param_subs_dropped': lane['subs_dropped'],
              'param_subs_reaped': lane['subs_reaped'],
              'conns_reaped': self._conns_reaped.value,
              'heartbeat_misses': self._heartbeat_misses.value,
              'stale_epoch_rejected': self._stale_epoch_rejected.value,
              'reattached': self._reattached,
              'reconnected': self._reconnected,
              'reattach_latency_secs': round(self._reattach_latency, 3),
              'session_epoch': self.session_epoch,
              'ingest_threads_wedged': len(wedged),
              'wedged_thread_names': wedged,
              'unjoined_threads': self._unjoined_threads}

  def _wedged_threads(self) -> List[str]:
    """Service threads with no watchdog beat past the stall deadline
    (liveness mode only: a blocking idle reader never beats)."""
    if not self._liveness_on:
      return []
    return self._watchdog.wedged(max(3 * self._stall_secs, 15.0))

  def _reap_loop(self):
    """Close trajectory-lane connections silent past the idle window,
    and count heartbeat misses of v6 peers."""
    while not self._closed.wait(max(self._poll_secs / 2, 0.05)):
      self._watchdog.beat('ingest-reaper')
      now = time.monotonic()
      with self._conns_lock:
        conns = list(self._conns)
      for conn in conns:
        if conn.is_waiting_on_us():
          # Its unroll is in flight: the peer awaits our ack.
          continue
        # A v5 peer cannot ping: a generous multiple of the window.
        idle_window = (self._idle_timeout if conn.heartbeat
                       else 5 * self._idle_timeout)
        silent = now - conn.last_recv
        if (conn.heartbeat and not conn.hb_missed
            and silent > 2 * self._heartbeat_secs):
          conn.hb_missed = True
          self._heartbeat_misses.inc()
          log.warning('remote actor %s missed its heartbeat window '
                      '(silent %.1fs, cadence %.1fs)', conn.addr,
                      silent, self._heartbeat_secs)
        if silent > idle_window and not conn.reaped:
          conn.reaped = True
          self._conns_reaped.inc()
          log.warning('reaping idle/half-open connection %s (silent '
                      '%.1fs > %.1fs window)', conn.addr, silent,
                      self._idle_timeout)
          try:
            conn.sock.shutdown(socket.SHUT_RDWR)
          except OSError:
            pass
          try:
            conn.sock.close()
          except OSError:
            pass
    self._watchdog.unregister('ingest-reaper')

  def _ingest_worker(self, name: str = 'ingest-worker'):
    """The validate/commit/ack loop, off the reader threads."""
    try:
      self._ingest_worker_loop(name)
    finally:
      self._watchdog.unregister(name)

  def _ingest_worker_loop(self, name: str):
    while True:
      self._watchdog.beat(name)
      try:
        job = self._ingest_q.get(timeout=1.0)
      except queue.Empty:
        if self._closed.is_set():
          return
        continue
      if job is None:
        return
      (conn, unroll, t_recv, client_version, client_epoch, crc_pair,
       trace) = job
      try:
        if crc_pair is not None and crc_pair[0] != crc_pair[1]:
          # The frame's bytes are not the bytes sent: refused before any
          # other check and before the put; the connection stays.
          computed, wire = crc_pair
          self._wire_crc_rejected.inc()
          conn.crc_rejected += 1
          log.warning(
              'unroll from %s failed its CRC trailer (computed '
              '%08x, wire %08x) — refused before the buffer put',
              conn.addr, computed, wire)
          conn.send(('corrupt', computed))
          continue
        if (client_epoch is not None
            and client_epoch != self.session_epoch):
          # A dead incarnation's unroll: never buffered.
          self._stale_epoch_rejected.inc()
          conn.send(('stale_epoch', self.session_epoch))
          continue
        if self._max_staleness and client_version is not None:
          with self._params_lock:
            current = self._version
          if current - int(client_version) > self._max_staleness:
            self._stale_rejected.inc()
            conn.stale_rejected += 1
            conn.send(('stale', current))
            continue
        if self._validate is not None:
          problems = self._validate(unroll)
          if problems:
            # Refused without touching the buffer; the actor decides
            # whether that is fatal.
            self._rejected.inc()
            conn.send(('error', 'unroll rejected: '
                       + '; '.join(problems)))
            continue
        # Trace span: stamp commit and tag the unroll before the put, so
        # the learner cannot consume it untagged; a piggybacked install
        # notice ('pi') becomes the tracer's install record.
        tracer = telemetry.get_tracer()
        if trace is not None and tracer is not None:
          telemetry.stamp(trace, telemetry.HOP_COMMIT)
          with self._params_lock:
            trace['cv'] = self._version
          install = trace.pop('pi', None)
          if install is not None:
            try:
              tracer.on_install(trace.get('a', conn.addr),
                                install[0], install[1])
            except (TypeError, IndexError):
              pass  # a malformed notice: dropped
          tracer.tag(unroll, trace)
        # The blocking put is the backpressure (polled, so close() can
        # interrupt it); the reader sends the busy keepalives.
        while True:
          try:
            self._buffer.put(unroll, timeout=1.0)
            break
          except TimeoutError:
            if self._closed.is_set():
              return
            self._watchdog.beat(name)
        self._unrolls.inc()
        conn.unrolls += 1
        with self._params_lock:
          version = self._version
        conn.send(('ack', version))
        self._ack_hist.observe((time.monotonic() - t_recv) * 1e3)
      except ring_buffer.Closed:
        return  # the learner shut down
      except (ConnectionError, OSError):
        pass  # the peer is gone; its reader cleans up
      except Exception:
        log.exception('ingest worker failed on an unroll')
      finally:
        conn.job_finished()

  def _accept_loop(self):
    while not self._closed.is_set():
      try:
        conn, addr = self._listener.accept()
      except OSError:
        return  # listener closed
      conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      if self._liveness_on:
        # Timeout mode: the reader polls and every send is bounded.
        conn.settimeout(self._poll_secs)
        wrapped = _Conn(conn, addr=addr,
                        send_stall_secs=self._stall_secs,
                        base_timeout=self._poll_secs)
      else:
        wrapped = _Conn(conn, addr=addr)
      t = threading.Thread(target=self._serve, args=(wrapped, addr),
                           name=f'ingest-{addr}', daemon=True)
      with self._conns_lock:
        if self._closed.is_set():
          conn.close()
          return
        self._conns.append(wrapped)
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)
        # Started under the lock: close() snapshots the list under it and
        # joins every thread it holds, which must have started (the JAX
        # package starts it after the lock, and its close() can meet an
        # unstarted reader).
        t.start()
      with self._stats_lock:
        self._connections += 1

  def _snapshot_frame(
      self, proto: int = PROTOCOL_VERSION) -> Tuple[List, bytes]:
    """The current version's (cached frame segments, trailer); a v<=9
    peer of an int8 publisher gets the bfloat16 blob."""
    with self._params_lock:
      if self._wire_int8 and proto < 10:
        return self._params_frame_compat
      return self._params_frame

  def snapshot_nbytes(self, proto: int = PROTOCOL_VERSION) -> int:
    """The wire size of the current cached snapshot frame."""
    return sum(memoryview(s).nbytes
               for s in self._snapshot_frame(proto)[0])

  def attach_serving(self, fn) -> None:
    """Attach the routed-inference function (`fn(payload dict) ->
    result dict`); None detaches."""
    with self._params_lock:
      self._serving_fn = fn

  def set_draining(self, draining: bool = True) -> None:
    """Flip the drain notice that 'infer' replies carry."""
    with self._params_lock:
      self._draining = bool(draining)

  def _serve(self, conn: _Conn, addr):
    log.info('remote actor connected from %s', addr)
    # With a contract, no unroll is accepted before this connection's
    # hello matched.
    handshaken = self._contract is None
    adopted = False
    leave_to_close = False  # close() owns the teardown
    thread_name = f'ingest-reader-{addr}'
    liveness = _ConnLiveness(
        conn, self._closed, self._stall_secs,
        watchdog=self._watchdog if self._liveness_on else None,
        name=thread_name, heartbeat_secs=self._heartbeat_secs)
    liveness.beat()
    crc_ctx = None  # armed once the hello negotiates CRC
    try:
      while not self._closed.is_set():
        msg = _recv_msg(conn.sock, liveness, crc_ctx)
        if msg is None:
          return  # the client went away
        kind = msg[0]
        if kind == 'hello':
          offered = msg[1] if len(msg) > 1 else None
          if self._contract is not None:
            problem = contract_mismatch_message(self._contract, offered)
            if problem is not None:
              log.warning('rejecting actor %s: %s', addr, problem)
              conn.send(('reject', problem))
              return
            handshaken = True
          if isinstance(offered, dict):
            conn.protocol = int(offered.get('protocol') or 5)
          conn.heartbeat = (conn.protocol >= 6
                            and self._heartbeat_secs > 0)
          client_info = msg[2] if len(msg) > 2 else None
          # CRC: the peer's protocol, the server's knob, the client's
          # offer and the algorithm must all agree. It takes effect after
          # the hello reply, which ships per the prior state.
          crc_next = (conn.protocol >= 7 and self._wire_crc
                      and isinstance(client_info, dict)
                      and bool(client_info.get('crc'))
                      and client_info.get('crc_algo') ==
                      integrity.CRC_ALGO)
          prior_epoch = (client_info or {}).get('epoch') \
              if isinstance(client_info, dict) else None
          try:
            prior_epoch = (None if prior_epoch is None
                           else int(prior_epoch))
          except (TypeError, ValueError):
            prior_epoch = None  # a garbage epoch: a fresh hello
          if prior_epoch is not None:
            with self._stats_lock:
              if prior_epoch != self.session_epoch:
                self._reattached += 1
                self._reattach_latency = (time.monotonic()
                                          - self._t_start)
                log.info(
                    'remote actor %s REATTACHED across a learner '
                    'restart (prior epoch %d -> %d) %.2fs after '
                    'server start', addr, prior_epoch,
                    self.session_epoch, self._reattach_latency)
              else:
                self._reconnected += 1
          # Membership: only a new identity is a join; a reconnect of a
          # known host re-points its entry at this connection.
          host_id = (client_info.get('host')
                     if isinstance(client_info, dict) else None)
          if isinstance(host_id, str) and host_id:
            conn.host_id = host_id
            with self._conns_lock:
              fresh = host_id not in self._members
              self._members[host_id] = conn
              if fresh:
                self._member_events.append(
                    {'kind': 'host_joined', 'host': host_id,
                     'reattach': prior_epoch is not None})
            if fresh:
              self._hosts_joined.inc()
              log.info('host %s JOINED the pod (%s)', host_id, addr)
          segments, trailer = self._snapshot_frame(conn.protocol)
          conn.send_segments(segments,
                             trailer if conn.crc else None)
          conn.crc = crc_next
          crc_ctx = _CrcContext() if conn.crc else None
        elif kind == 'ping':
          with self._params_lock:
            version = self._version
          conn.send(('pong', version))
        elif kind == 'hello_params':
          # The whole connection moves to the param lane; 'connections'
          # counts actor connections only.
          with self._stats_lock:
            self._connections -= 1
            self._param_subscribers += 1
          sub_info = msg[1] if len(msg) > 1 else None
          sub_crc = (self._wire_crc and isinstance(sub_info, dict)
                     and bool(sub_info.get('crc'))
                     and sub_info.get('crc_algo') ==
                     integrity.CRC_ALGO)
          sub_proto = conn.protocol
          if isinstance(sub_info, dict) and sub_info.get('protocol'):
            sub_proto = int(sub_info['protocol'])
          adopted = self._param_lane.adopt(conn.sock, crc=sub_crc,
                                           proto=sub_proto)
          return
        elif kind == 'get_params':
          # The in-band path of old peers and protocol tests.
          segments, trailer = self._snapshot_frame(conn.protocol)
          conn.send_segments(segments,
                             trailer if conn.crc else None)
        elif kind == 'unroll':
          if not handshaken:
            # 'error', which every client version fails loudly on.
            conn.send(('error',
                       'unroll before a successful hello handshake — '
                       'upgrade/fix the actor host'))
            continue
          # In flight from here until the worker's reply: this
          # connection's silence is the protocol, not a liveness signal.
          conn.job_started()
          trace = msg[4] if len(msg) > 4 else None
          if isinstance(trace, dict):
            telemetry.stamp(trace, telemetry.HOP_WIRE)
          else:
            trace = None
          self._ingest_q.put((conn, msg[1], time.monotonic(),
                              msg[2] if len(msg) > 2 else None,
                              msg[3] if len(msg) > 3 else None,
                              (crc_ctx.computed, crc_ctx.wire)
                              if crc_ctx is not None else None,
                              trace))
        elif kind == 'leave':
          # A deliberate exit: the unwind records host_left('drain').
          conn.draining = True
          conn.send(('bye_ack',))
          log.info('host %s announced drain from %s',
                   conn.host_id or '<unnamed>', addr)
          return
        elif kind == 'stats':
          conn.send(('stats', {
              'registry': telemetry.registry().snapshot(),
              'ingest': self.stats(),
          }))
        elif kind == 'infer':
          with self._params_lock:
            serving_fn = self._serving_fn
            draining = self._draining
          if serving_fn is None:
            conn.send(('error', 'serving not attached'))
          else:
            try:
              result = serving_fn(msg[1])
            except Exception as e:
              log.exception('routed inference request failed')
              conn.send(('error',
                         f'infer failed: {type(e).__name__}: {e}'))
            else:
              conn.send_oob(('infer_ok', result,
                             {'draining': draining}))
        else:
          conn.send(('error', f'unknown message kind {kind!r}'))
      leave_to_close = True
    except ring_buffer.Closed:
      pass  # the learner shut down
    except _ServerClosing:
      leave_to_close = True
    except _FrameStall as e:
      # A half-open peer caught mid-frame: the partial frame never
      # reached the workers, and is discarded with the connection.
      conn.reaped = True
      self._conns_reaped.inc()
      self._discarded_frames.inc()
      self._discarded_bytes.inc(liveness.frame_bytes)
      log.warning('reaping half-open connection %s: %s (partial '
                  'frame discarded: %d byte(s))', addr, e,
                  liveness.frame_bytes)
    except (ValueError, struct.error, pickle.UnpicklingError,
            EOFError) as e:
      # An unparseable frame (a version-skewed peer or garbage):
      # quarantine this connection only, with the discarded bytes.
      self._quarantined.inc()
      self._discarded_frames.inc()
      self._discarded_bytes.inc(liveness.frame_bytes)
      log.warning(
          'protocol/frame error from %s — connection quarantined '
          '(version-skewed peer? this learner speaks v%d; %d byte(s) '
          'discarded): %s', addr, PROTOCOL_VERSION,
          liveness.frame_bytes, e)
    except (ConnectionError, OSError) as e:
      if conn.reaped:
        log.info('remote actor %s reader unwound after reap', addr)
      elif not self._closed.is_set():
        log.warning('remote actor %s dropped: %s', addr, e)
    finally:
      self._watchdog.unregister(thread_name)
      if not adopted and not leave_to_close:
        conn.sock.close()
      if not leave_to_close:
        left_as = None
        with self._conns_lock:
          if conn in self._conns:
            self._conns.remove(conn)
          # Only the connection owning the identity records the exit.
          if (conn.host_id is not None
              and self._members.get(conn.host_id) is conn):
            del self._members[conn.host_id]
            reason = ('drain' if conn.draining
                      else 'reaped' if conn.reaped else 'lost')
            left_as = reason
            self._member_events.append(
                {'kind': 'host_left', 'host': conn.host_id,
                 'reason': reason})
        if left_as is not None:
          self._hosts_left.inc()
          log.warning('host %s LEFT the pod (%s)', conn.host_id,
                      left_as)
      if not adopted and not leave_to_close:
        log.info('remote actor %s disconnected', addr)

  def close(self, graceful: bool = True):
    """Shut the server down. graceful=True sends every actor a 'bye'
    (they exit instead of reconnecting), half-closing, then reading what
    a peer still sends until it goes quiet, so the bye is not lost to an
    RST (the JAX package's close skips that drain); graceful=False is
    crash semantics for a
    learner about to restart (actors keep retrying). Every step is
    time-bounded; threads that miss their join deadline are counted in
    stats()['unjoined_threads']."""
    self._closed.set()
    # shutdown() before close() wakes a blocked accept() and frees the
    # port at once.
    try:
      self._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
      pass
    try:
      self._listener.close()
    except OSError:
      pass
    for _ in self._workers:
      try:
        self._ingest_q.put(None, timeout=2.0)
      except queue.Full:
        log.warning('ingest close: handoff queue full; worker will '
                    'exit via the closed flag or leak as a daemon')
        break
    unjoined: List[str] = []
    if self._param_lane.close(graceful=graceful):
      unjoined.append('param-lane')
    with self._conns_lock:
      conns = list(self._conns)
      threads = list(self._threads)
    for conn in conns:
      if graceful:
        conn.try_send(('bye',))
        try:
          conn.sock.shutdown(socket.SHUT_WR)
        except OSError:
          pass
      else:
        try:
          conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
          pass
        conn.sock.close()
    for t in threads:
      t.join(timeout=2.0)
      if t.is_alive():
        unjoined.append(t.name)
    if graceful:
      # No RST over the bye: drop what a peer still sends first.
      deadline = time.monotonic() + 2.0
      for conn in conns:
        _drain_until_quiet(conn.sock, deadline)
        conn.sock.close()
    for w in self._workers:
      w.join(timeout=2.0)
      if w.is_alive():
        unjoined.append(w.name)
    self._accept_thread.join(timeout=2.0)
    if self._accept_thread.is_alive():
      unjoined.append('ingest-accept')
    if self._reaper_thread is not None:
      self._reaper_thread.join(timeout=2.0)
      if self._reaper_thread.is_alive():
        unjoined.append('ingest-reaper')
    with self._stats_lock:
      self._unjoined_threads = len(unjoined)
    if unjoined:
      log.warning(
          'TrajectoryIngestServer.close(): %d thread(s) missed the '
          'join deadline and leak as daemons: %s', len(unjoined),
          ', '.join(unjoined))


class RemoteActorClient:
  """Actor side of the ingest server: unrolls and acks ride the
  trajectory connection opened here; `fetch_params` opens a second one
  onto the param lane ('hello_params'). Strict request -> reply per
  socket; not thread-safe (one pump thread owns it).

  `io_timeout_secs` > 0 puts a deadline on both sockets' receives and
  sends: a silent learner becomes a ConnectionError within it, while
  ('busy',) keepalives keep a backpressured learner inside it. The
  handshake learns `server_info` and `session_epoch`; the epoch stamps
  every unroll."""

  def __init__(self, address: str, connect_timeout_secs: float = 60.0,
               io_timeout_secs: float = 0.0, wire_crc: bool = True):
    host, port = address.rsplit(':', 1)
    self._addr = (host, int(port))
    self._io_timeout = (float(io_timeout_secs)
                        if io_timeout_secs and io_timeout_secs > 0
                        else None)
    self._param_sock: Optional[socket.socket] = None
    self.stale_rejections = 0
    self.server_info: Dict = {}
    self.session_epoch: Optional[int] = None
    self.busy_frames = 0
    # CRC: offered at hello (`wire_crc`), on once the handshake reply
    # confirms it. `crc_rejected` counts ('corrupt', crc) refusals of
    # this host's unrolls, `digest_rejected` snapshots refused before
    # install (the version rides the next fetch as a notice).
    self._wire_crc = bool(wire_crc)
    self._crc = False
    self._param_sock_crc = False  # the param lane's pinned CRC state
    self.crc_rejected = 0
    self.digest_rejected = 0
    self._digest_nack: Optional[int] = None
    # Tracing: on when the handshake reply advertises a tracing
    # learner; the latest install event rides the next traced unroll.
    self.trace_ok = False
    self._pending_install: Optional[List] = None
    deadline = time.monotonic() + connect_timeout_secs
    last_err = None
    backoff = Backoff(base=0.2, cap=5.0)
    while True:
      try:
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=10.0)
        if self._sock.getsockname() == self._sock.getpeername():
          # A localhost self-connect while the learner's port is down
          # (TCP simultaneous open with our own ephemeral port).
          self._sock.close()
          raise OSError('self-connect while learner port is down')
        break
      except OSError as e:  # the learner may not be up yet
        last_err = e
        if time.monotonic() > deadline:
          raise ConnectionError(
              f'could not reach learner at {address}: {e}') from e
        backoff.sleep()
    self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    self._sock.settimeout(self._io_timeout)
    log.info('connected to learner at %s (after %s)', address, last_err)

  def _rpc(self, msg, oob: bool = False):
    _raise_on_pending_bye(self._sock, self._crc)
    # The scripted transport faults: a delay before the send; a
    # blackhole goes silent without closing; a transport fault damages
    # and closes the socket.
    plan = faults_lib.active()
    delay = faults_lib.fire('conn_delay')
    if delay is not None:
      faults_lib.apply_conn_delay(delay, seed=plan.seed if plan else 0)
    partition = faults_lib.fire('conn_partition')
    if partition is not None:
      faults_lib.apply_conn_partition(partition)
    fault = faults_lib.fire('transport_send')
    if fault is not None:
      faults_lib.apply_transport_fault(
          fault, self._sock, seed=plan.seed if plan else 0)
    if oob:
      _send_oob(self._sock, msg, crc=self._crc)
    else:
      _send_msg(self._sock, msg, crc=self._crc)
    crc_ctx = _CrcContext() if self._crc else None
    while True:
      try:
        reply = _recv_msg(self._sock, crc_ctx=crc_ctx)
      except socket.timeout as e:
        raise ConnectionError(
            f'learner silent past the {self._io_timeout}s I/O '
            'deadline (no ack, no busy keepalive) — treating the '
            'connection as dead') from e
      except (ValueError, struct.error, pickle.UnpicklingError,
              EOFError) as e:
        raise ProtocolError(
            f'unparseable reply from the learner ({e!r}) — likely a '
            f'protocol-version skew (this client speaks '
            f'v{PROTOCOL_VERSION}); upgrade both roles together') from e
      if reply is None:
        raise ConnectionError('learner closed the connection')
      if crc_ctx is not None and not crc_ctx.ok:
        # The learner -> actor direction corrupts: a fresh connection
        # is the recovery.
        raise ConnectionError(
            f'learner reply failed its CRC trailer (computed '
            f'{crc_ctx.computed:08x}, wire {crc_ctx.wire:08x})')
      if reply[0] == 'busy':
        self.busy_frames += 1
        continue
      break
    if reply[0] == 'bye':
      raise LearnerShutdown('learner finished training')
    if reply[0] == 'reject':
      raise ContractMismatch(reply[1])
    if reply[0] == 'corrupt':
      self.crc_rejected += 1
      raise UnrollCorrupt(
          f'learner refused the unroll: payload CRC mismatch (its '
          f'computed crc {reply[1]:08x}) — re-send once, then treat '
          'this host as suspect', crc=reply[1])
    if reply[0] == 'stale_epoch':
      raise SessionEpochMismatch(
          f'learner refused this client\'s session epoch '
          f'{self.session_epoch} (its current epoch: {reply[1]}) — '
          'the learner restarted; re-handshake required')
    if reply[0] == 'error':
      raise RuntimeError(f'learner rejected request: {reply[1]}')
    return reply

  def _decode_params(self, reply, negotiate: bool = False,
                     offered_protocol: Optional[int] = None
                     ) -> Tuple[int, object]:
    """(version, tree) of a params reply, float32 leaves whatever the
    wire form. The server-info (4th element) is recorded; its
    'params_digest' is checked against the wire-form tree before the
    decode, and a mismatch raises ParamsCorrupt (nothing installed).
    The CRC negotiation resolves only on a handshake reply
    (`negotiate`), since the server pins its side at the hello."""
    version, tree = reply[1], reply[2]
    if len(reply) > 3 and isinstance(reply[3], dict):
      self.server_info = reply[3]
      epoch = reply[3].get('session_epoch')
      if epoch is not None:
        self.session_epoch = epoch
      if negotiate:
        self._crc = (self._wire_crc
                     and int(self.server_info.get('protocol') or 0)
                     >= 7
                     and bool(self.server_info.get('wire_crc'))
                     and self.server_info.get('crc_algo') ==
                     integrity.CRC_ALGO)
      if offered_protocol is not None:
        # Traces only when both sides speak v8 and the learner traces.
        self.trace_ok = (int(offered_protocol) >= 8
                         and int(self.server_info.get('protocol')
                                 or 0) >= 8
                         and bool(self.server_info.get('trace')))
      record = self.server_info.get('params_digest')
      if record is not None:
        verdict = integrity.verify_record(record, _wire_digest(tree))
        if verdict is False:
          self.digest_rejected += 1
          self._digest_nack = int(version)
          raise ParamsCorrupt(
              f'params v{version} failed its content digest '
              f'(recorded {record}) — snapshot NOT installed; keep '
              'the prior params and refetch on backoff',
              version=int(version))
        if verdict is None:
          log.warning(
              'params digest not comparable (recorded %r, local algo '
              '%s) — content verification skipped', record,
              integrity.CRC_ALGO)
    if reply[0] == 'params_bf16':
      tree = codec_lib.from_bf16_np(tree)
    elif reply[0] == 'params_int8':
      tree = codec_lib.dequantize_np(tree)
    return version, tree

  def handshake(self, contract, prior_epoch: Optional[int] = None,
                host: Optional[str] = None) -> Tuple[int, object]:
    """Offer this host's contract; returns (version, params) on
    agreement, raises ContractMismatch naming the offending fields on
    refusal. The client-info dict carries the prior session epoch (a
    restarted learner counts the reattach), the CRC offer (only when
    the contract speaks v7, so both sides land on the same negotiation)
    and the membership `host` identity."""
    offered_protocol = (contract.get('protocol')
                        if isinstance(contract, dict) else None)
    offer_crc = (self._wire_crc and offered_protocol is not None
                 and int(offered_protocol) >= 7)
    info: Dict = {}
    if prior_epoch is not None:
      info['epoch'] = int(prior_epoch)
    if offer_crc:
      info['crc'] = True
      info['crc_algo'] = integrity.CRC_ALGO
    if host is not None:
      info['host'] = str(host)
    msg = ('hello', contract, info) if info else ('hello', contract)
    if not offer_crc:
      self._crc = False
    self.trace_ok = False  # renegotiated below
    return self._decode_params(
        self._rpc(msg), negotiate=offer_crc,
        offered_protocol=(int(offered_protocol)
                          if offered_protocol is not None else None))

  def ping(self) -> int:
    """The heartbeat on the trajectory lane: keeps an idle connection
    inside the reaping window and returns the learner's current params
    version."""
    reply = self._rpc(('ping',))
    if reply[0] != 'pong':
      raise ProtocolError(f'expected pong, got {reply[0]!r}')
    return reply[1]

  def fetch_params(self) -> Tuple[int, object]:
    """(version, host param tree) over the param lane. A failure closes
    the param socket and raises ConnectionError/OSError; a cached lane
    that died between fetches (reaped while quiet) is retried once on a
    fresh socket first."""
    had_cached_lane = self._param_sock is not None
    try:
      return self._fetch_params_once()
    except (ConnectionError, OSError) as e:
      if not had_cached_lane:
        raise
      log.info('param lane died between fetches (%s); retrying once '
               'on a fresh subscriber connection', e)
      return self._fetch_params_once()

  def _fetch_params_once(self) -> Tuple[int, object]:
    if self._param_sock is None:
      try:
        sock = socket.create_connection(self._addr, timeout=10.0)
      except OSError:
        raise ConnectionError(
            f'could not open the param lane to {self._addr}')
      sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      sock.settimeout(self._io_timeout)
      # The lane's CRC state is pinned at open; its info always carries
      # the protocol (which blob encoding this subscriber gets).
      if self._crc:
        _send_msg(sock, ('hello_params',
                         {'protocol': PROTOCOL_VERSION, 'crc': True,
                          'crc_algo': integrity.CRC_ALGO}))
      else:
        _send_msg(sock, ('hello_params',
                         {'protocol': PROTOCOL_VERSION}))
      self._param_sock = sock
      self._param_sock_crc = self._crc
    lane_crc = self._param_sock_crc
    try:
      _raise_on_pending_bye(self._param_sock, lane_crc)
      # A digest-rejected notice rides the retry fetch.
      if self._digest_nack is not None:
        req = ('get_params', {'digest_rejected': self._digest_nack})
      else:
        req = ('get_params',)
      self._digest_nack = None
      _send_msg(self._param_sock, req, crc=lane_crc)
      crc_ctx = _CrcContext() if lane_crc else None
      reply = _recv_msg(self._param_sock, crc_ctx=crc_ctx)
      if reply is not None and crc_ctx is not None and not crc_ctx.ok:
        self._close_param_sock()
        raise ConnectionError(
            f'param blob failed its CRC trailer (computed '
            f'{crc_ctx.computed:08x}, wire {crc_ctx.wire:08x}) — '
            'wire corruption; refetching on a fresh subscriber')
    except socket.timeout as e:
      self._close_param_sock()
      raise ConnectionError(
          f'param lane silent past the {self._io_timeout}s I/O '
          'deadline') from e
    except (ValueError, struct.error, pickle.UnpicklingError,
            EOFError) as e:
      self._close_param_sock()
      raise ProtocolError(
          f'unparseable param-lane reply ({e!r}) — likely a '
          f'protocol-version skew (this client speaks '
          f'v{PROTOCOL_VERSION}); upgrade both roles together') from e
    except OSError:
      self._close_param_sock()
      raise
    except (LearnerShutdown, ProtocolError):
      self._close_param_sock()
      raise
    if reply is None:
      self._close_param_sock()
      raise ConnectionError('learner closed the param lane')
    if reply[0] == 'bye':
      self._close_param_sock()
      raise LearnerShutdown('learner finished training (param lane)')
    if reply[0] == 'error':
      raise RuntimeError(f'learner rejected param fetch: {reply[1]}')
    return self._decode_params(reply)

  def _close_param_sock(self):
    if self._param_sock is not None:
      try:
        self._param_sock.close()
      except OSError:
        pass
      self._param_sock = None

  def note_install(self, version: int):
    """Record a params install; the event rides the next traced unroll
    ('pi'), the learner's publish -> install hop."""
    self._pending_install = [int(version), round(time.time(), 6)]

  def send_unroll(self, unroll,
                  params_version: Optional[int] = None,
                  trace: Optional[Dict] = None) -> int:
    """Ship one ActorOutput of numpy leaves as an OOB frame; returns the
    learner's params version. `params_version` rides along for the
    staleness window (a ('stale', current) refusal counts on
    `stale_rejections` and returns the newer version); the session
    epoch stamps the frame once a v6 handshake taught it; `trace` (when
    negotiated) is stamped 'send' and shipped as the 5th element."""
    if trace is not None and self.trace_ok:
      telemetry.stamp(trace, telemetry.HOP_SEND)
      if self._pending_install is not None:
        trace['pi'] = self._pending_install
        self._pending_install = None
      msg = ('unroll', unroll,
             None if params_version is None else int(params_version),
             None if self.session_epoch is None
             else int(self.session_epoch),
             trace)
    elif self.session_epoch is not None:
      msg = ('unroll', unroll,
             None if params_version is None else int(params_version),
             int(self.session_epoch))
    elif params_version is None:
      msg = ('unroll', unroll)
    else:
      msg = ('unroll', unroll, int(params_version))
    reply = self._rpc(msg, oob=True)
    if reply[0] == 'stale':
      self.stale_rejections += 1
    return reply[1]

  def fetch_stats(self) -> Dict:
    """The learner's telemetry: {'registry': its registry snapshot,
    'ingest': its ingest stats}."""
    reply = self._rpc(('stats',))
    if reply[0] != 'stats':
      raise ProtocolError(f'expected stats, got {reply[0]!r}')
    return reply[1]

  def supports_infer(self) -> bool:
    """True when the handshaken server advertised protocol >= 10: the
    routed-inference capability (routing.py skips an older replica
    instead of spending a request on its 'error' reply)."""
    return int(self.server_info.get('protocol') or 0) >= 10

  def remote_infer(self, payload: dict) -> Tuple[dict, dict]:
    """One routed inference batch: ship `payload` (InferenceServer.
    serve_remote's dict of batch-leading numpy arrays) out of band and
    return (result dict, notice dict); the notice carries 'draining',
    which routing.py turns into no new picks. Raises RuntimeError against
    a server with nothing attached (or one older than protocol 10)."""
    reply = self._rpc(('infer', payload), oob=True)
    if reply[0] == 'error':
      raise RuntimeError(f'routed inference refused: {reply[1]}')
    if reply[0] != 'infer_ok':
      raise ProtocolError(f'expected infer_ok, got {reply[0]!r}')
    notice = reply[2] if len(reply) > 2 and isinstance(reply[2], dict) \
        else {}
    return reply[1], notice

  def send_leave(self) -> bool:
    """Announce a deliberate exit (the learner records
    host_left('drain')). Best effort: False against an old server or a
    dead connection."""
    try:
      reply = self._rpc(('leave', {}))
    except (RuntimeError, OSError, LearnerShutdown):
      return False
    return reply[0] == 'bye_ack'

  def close(self):
    self._close_param_sock()
    try:
      self._sock.close()
    except OSError:
      pass


def _raise_on_pending_bye(sock: socket.socket, crc: bool) -> None:
  """Between requests a lockstep peer owes nothing but a late ('busy',)
  (a keepalive that crossed its ack) and, from a learner that closed
  meanwhile, the 'bye': read what is pending before sending, and raise
  LearnerShutdown on a bye. A send into the closed socket would
  otherwise end in a reset (a broken pipe mid-unroll) and the reconnect
  window, with the bye unread. (The JAX package's client sends first.)"""
  while select.select([sock], [], [], 0)[0]:
    crc_ctx = _CrcContext() if crc else None
    try:
      msg = _recv_msg(sock, crc_ctx=crc_ctx)
    except (ValueError, struct.error, pickle.UnpicklingError,
            EOFError) as e:
      raise ProtocolError(
          f'unparseable frame between requests ({e!r})') from e
    if msg is None:
      raise ConnectionError('learner closed the connection')
    if msg[0] == 'bye':
      raise LearnerShutdown('learner finished training')
    if msg[0] != 'busy':
      raise ProtocolError(f'unexpected {msg[0]!r} frame between requests')


def _as_tensors(params) -> Dict:
  """The port's parameter dict (tensors by name) of a fetched tree."""
  import torch
  return {name: torch.from_numpy(np.ascontiguousarray(value))
          for name, value in params.items()}


def run_remote_actor(config, learner_address: str, task: int = 0,
                     stop_after_unrolls: Optional[int] = None,
                     device='cuda',
                     connect_timeout_secs: float = 120.0,
                     reconnect_secs: Optional[float] = None) -> int:
  """The actor-only host (reference --job_name=actor --task=N): an
  inference server and actor fleet on `device` (CUDA by default; it
  raises without it unless the caller asks for the CPU) against params
  fetched from the learner, a pump shipping unrolls to the learner's
  ingest, and a param refresh whenever an ack reports a newer version.
  Returns the unrolls shipped. Runs until the learner says 'bye' (the end
  of training), `stop_after_unrolls`, a SIGTERM (drain: quiesce the
  fleet, announce 'leave', exit), or a self-quarantine.

  Args:
    config: the learner's Config (the env and model knobs must agree;
      the handshake refuses a skew).
    learner_address: host:port of the learner's ingest server.
    task: this host's index: env seeds start at
      _REMOTE_SEED_SPACE + task * max(num_actors, 1000) and actor i
      plays level (task * num_actors + i).
    reconnect_secs: defaults to config.actor_reconnect_secs: when > 0, a
      dropped connection is retried for this long (the fleet waits on
      backpressure meanwhile), then feeding resumes with fresh params
      under the learner's new epoch. Delivery is at-least-once: an unroll
      whose ack was lost in the drop is resent.
  """
  from scalable_agent_tpu_torch import config as config_lib
  from scalable_agent_tpu_torch import driver as driver_lib
  from scalable_agent_tpu_torch.envs import factory
  from scalable_agent_tpu_torch.runtime.inference import InferenceServer

  device = driver_lib.resolve_device(device)
  if reconnect_secs is None:
    reconnect_secs = config.actor_reconnect_secs
  # validate_controller carries the cross-link of the CRC probation
  # cool-down (slept on this host's pump) and the idle-reaping window.
  for warning in (config_lib.validate_transport(config)
                  + config_lib.validate_integrity(config)
                  + config_lib.validate_controller(config)):
    log.warning('%s', warning)
  # The idle window is also how long this host waits on a silent
  # learner.
  io_timeout = config.remote_conn_idle_timeout_secs
  wire_crc = bool(config.wire_crc)
  levels = factory.level_names(config)
  spec0 = factory.make_env_spec(config, levels[0], seed=1)
  agent = driver_lib.build_agent(config, spec0.num_actions,
                                 num_tasks=len(levels))
  contract = trajectory_contract(config, agent, spec0.num_actions)
  # The membership identity: stable across this process's reconnects,
  # new for a replacement process.
  host_id = f'{socket.gethostname()}:{os.getpid()}:task{task}'
  client = RemoteActorClient(learner_address,
                             connect_timeout_secs=connect_timeout_secs,
                             io_timeout_secs=io_timeout,
                             wire_crc=wire_crc)
  unrolls_sent = 0
  # SIGTERM drains: the handler only sets the event. Off the main
  # thread signal.signal raises and the drain is not signal-driven.
  drain = threading.Event()

  def _on_sigterm(signum, frame):
    del signum, frame
    log.warning('remote actor task=%d received SIGTERM — draining '
                '(quiesce fleet, announce leave, exit)', task)
    drain.set()

  try:
    signal.signal(signal.SIGTERM, _on_sigterm)
  except ValueError:
    pass
  # The integrity ledger across reconnects.
  probation = CrcProbation(cooldown_secs=config.fleet_probation_secs)
  digest_rejections = 0
  self_quarantined = False
  try:
    # The hello reply is a cached params frame too: a corrupt publish
    # gets bounded retries here, as a refetch does.
    backoff = Backoff(base=0.3, cap=3.0)
    for attempt in range(5):
      try:
        version, params = client.handshake(contract, host=host_id)
        break
      except LearnerShutdown:
        log.info('learner already finished training; remote actor '
                 'exiting')
        return 0
      except ParamsCorrupt as e:
        digest_rejections += 1
        log.error('remote actor task=%d: handshake params failed '
                  'their digest (%s) — attempt %d/5', task, e,
                  attempt + 1)
        if attempt == 4:
          raise
        backoff.sleep()
    known_epoch = client.session_epoch  # None against a v5 learner
    # The heartbeat cadence is the server's (0 or absent: no pings).
    heartbeat_secs = float(
        client.server_info.get('heartbeat_secs') or 0.0)
    log.info('remote actor task=%d got params v%d (epoch=%s, '
             'heartbeat=%.1fs)', task, version, known_epoch,
             heartbeat_secs)

    seed_base = _REMOTE_SEED_SPACE + task * max(config.num_actors, 1000)
    server = InferenceServer(agent, _as_tensors(params), config,
                             seed=config.seed + seed_base,
                             fleet_size=config.num_actors, device=device)
    server.warmup(spec0.obs_spec, max_size=config.num_actors)
    buffer = ring_buffer.TrajectoryBuffer(
        max(2 * config.num_actors, 2))
    # Trace stamping: each completed unroll gets a context with the
    # params version it acted with (`version`, this function's live
    # binding); against a learner that does not trace the pump drops
    # them.
    if config.telemetry_trace:
      telemetry.configure_actor_tracing(version_fn=lambda: version,
                                        epoch=known_epoch)
    client.note_install(version)  # the handshake install is the first
    fleet = driver_lib.make_fleet(
        config, server.policy, buffer, levels,
        server.initial_core_state, seed_base=seed_base,
        level_offset=task * config.num_actors)
    fleet.start()

    def reconnect():
      """A new client and fresh params after a drop; False = gave up.
      The whole connect + handshake cycle is retried, with jittered
      backoff, until the deadline."""
      nonlocal client, version, known_epoch, heartbeat_secs
      client.close()
      deadline = time.monotonic() + reconnect_secs
      backoff = Backoff(base=0.2, cap=5.0)
      while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          log.info('remote actor task=%d gave up reconnecting', task)
          return False
        try:
          new_client = RemoteActorClient(learner_address,
                                         connect_timeout_secs=remaining,
                                         io_timeout_secs=io_timeout,
                                         wire_crc=wire_crc)
        except ConnectionError:
          continue  # the window is spent: the loop exits above
        try:
          v, new_params = new_client.handshake(contract,
                                               prior_epoch=known_epoch,
                                               host=host_id)
        except ContractMismatch:
          # The restarted learner runs another config: retrying cannot
          # succeed.
          new_client.close()
          raise
        except (OSError, RuntimeError):
          new_client.close()
          backoff.sleep()
          continue
        client = new_client
        version = v
        if (known_epoch is not None
            and new_client.session_epoch != known_epoch):
          log.warning(
              'remote actor task=%d RE-ATTACHED to a restarted '
              'learner (epoch %s -> %s); params refreshed to v%d',
              task, known_epoch, new_client.session_epoch, version)
        known_epoch = new_client.session_epoch
        heartbeat_secs = float(
            new_client.server_info.get('heartbeat_secs') or 0.0)
        server.update_params(_as_tensors(new_params))
        new_client.note_install(v)
        if config.telemetry_trace:
          telemetry.configure_actor_tracing(
              version_fn=lambda: version, epoch=known_epoch)
        log.info('remote actor task=%d reconnected, params v%d',
                 task, version)
        return True

    elastic = bool(reconnect_secs) and reconnect_secs > 0

    def resume_after_drop():
      """True to go on after a dropped connection; False to exit."""
      if elastic and reconnect():
        return True
      log.info('learner connection closed; remote actor exiting')
      return False

    def refresh_params():
      """Fetch and install the current snapshot. One failing its digest
      is not installed; retried on backoff three times, then the host
      keeps its params until the next ack's newer version."""
      nonlocal version, params, digest_rejections
      backoff = Backoff(base=0.2, cap=2.0)
      for attempt in range(3):
        try:
          v, p = client.fetch_params()
        except ParamsCorrupt as e:
          digest_rejections += 1
          log.error('remote actor task=%d: %s (attempt %d/3)', task,
                    e, attempt + 1)
          if attempt == 2:
            log.error(
                'remote actor task=%d: giving up on params v%s — '
                'keeping v%d; the next publish will be refetched',
                task, e.version, version)
            return
          backoff.sleep()
          continue
        version, params = v, p
        server.update_params(_as_tensors(params), version=version)
        client.note_install(version)
        log.info('remote actor task=%d refreshed params to v%d',
                 task, version)
        return

    try:
      unroll = None  # a drop mid-send must not lose the unroll
      unroll_trace = None  # its trace context rides every (re)send
      last_io = time.monotonic()
      while (not drain.is_set() and
             (stop_after_unrolls is None or
              unrolls_sent < stop_after_unrolls)):
        if unroll is None:
          probation.next_unroll()
          try:
            # With heartbeats, wake often enough to ping an idle lane.
            get_timeout = (min(10.0, heartbeat_secs)
                           if heartbeat_secs > 0 else 10.0)
            unroll = buffer.get(timeout=get_timeout)
            unroll_trace = telemetry.pop_unroll(unroll)
          except TimeoutError:
            fleet.check_health(stall_timeout_secs=300.0)
            errors = fleet.errors()
            if errors:
              raise errors[0]
            if (heartbeat_secs > 0 and
                time.monotonic() - last_io >= heartbeat_secs):
              try:
                pong_version = client.ping()
                last_io = time.monotonic()
                if pong_version > version:
                  refresh_params()
              except OSError:
                if not resume_after_drop():
                  break
                last_io = time.monotonic()
            continue
        try:
          ack_version = client.send_unroll(unroll,
                                           params_version=version,
                                           trace=unroll_trace)
        except UnrollCorrupt as e:
          # Once is wire noise: resend the same unroll. Twice: one
          # cooled-down probe, then quarantine on a repeat.
          last_io = time.monotonic()
          verdict = probation.on_refusal()
          if verdict == CrcProbation.QUARANTINE:
            self_quarantined = True
            log.error(
                'remote actor task=%d SELF-QUARANTINED: the same '
                'unroll failed the learner CRC twice (%s) — suspect '
                'NIC/memory on this host; exiting the fleet', task, e)
            break
          if verdict == CrcProbation.PROBE:
            log.error(
                'remote actor task=%d: CRC PROBATION — the same '
                'unroll failed the learner CRC twice (%s); cooling '
                'down %.1fs then sending ONE probe (repeat failure '
                'quarantines this host)', task, e,
                probation.cooldown_secs)
            # Cool down without going silent past the idle window.
            cool_end = time.monotonic() + probation.cooldown_secs
            while True:
              remaining = cool_end - time.monotonic()
              if remaining <= 0:
                break
              time.sleep(min(remaining, heartbeat_secs)
                         if heartbeat_secs > 0 else remaining)
              if heartbeat_secs > 0 and \
                 time.monotonic() < cool_end:
                try:
                  client.ping()
                except OSError:
                  break  # the probe's send owns the reconnect
            last_io = time.monotonic()
            continue
          log.warning('remote actor task=%d: unroll failed the '
                      'learner CRC (%s); re-sending once', task, e)
          continue
        except OSError:
          # A drop, an I/O deadline, or SessionEpochMismatch (the
          # learner restarted): the reconnect is the re-handshake.
          if resume_after_drop():
            last_io = time.monotonic()
            continue  # resend the same unroll on the new connection
          break
        last_io = time.monotonic()
        if probation.on_ack():
          log.warning(
              'remote actor task=%d: CRC probation probe ACCEPTED — '
              'host recovered; staying in the fleet', task)
        unroll = None
        unroll_trace = None
        unrolls_sent += 1
        if ack_version > version:
          try:
            refresh_params()
            last_io = time.monotonic()
          except OSError:
            if not resume_after_drop():
              break
            last_io = time.monotonic()
      if drain.is_set():
        # Quiesce first, then announce the deliberate exit.
        fleet.stop()
        acked = client.send_leave()
        log.warning('remote actor task=%d drained cleanly after %d '
                    'unroll(s) (leave %s)', task, unrolls_sent,
                    'acked' if acked else 'not acked — old learner?')
    except LearnerShutdown:
      log.info('learner finished training; remote actor exiting')
    except ring_buffer.Closed:
      log.info('local buffer closed; remote actor exiting')
    finally:
      telemetry.clear_actor_tracing()
      # The driver's teardown order: closing the buffer and the server
      # ends actors parked in a put or an inference call, so the join is
      # short and no actor thread outlives the process's C++ batcher.
      fleet.stop_event.set()
      buffer.close()
      server.close()
      fleet.stop()
  finally:
    client.close()
  log.info('remote actor task=%d shipped %d unrolls', task,
           unrolls_sent)
  if (probation.crc_resends or probation.probations
      or digest_rejections or self_quarantined):
    # The client half of the integrity ledger, one greppable line.
    log.warning(
        'INTEGRITY_REPORT task=%d crc_resends=%d digest_rejections=%d '
        'crc_probations=%d crc_probation_recoveries=%d '
        'self_quarantined=%s', task, probation.crc_resends,
        digest_rejections, probation.probations, probation.recoveries,
        self_quarantined)
  return unrolls_sent
