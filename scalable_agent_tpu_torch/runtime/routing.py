"""The cross-host serving router, ported from the JAX package's
runtime/routing.py under its names: an actor host that offloads
inference spreads its `remote_infer` batches over every learner host
that serves them (wire protocol 10), so one slow or dead replica costs
its share of the traffic and nothing else.

- **Smooth weighted round-robin** (nginx's): every pick adds each
  candidate's weight to its running credit, serves the highest credit,
  then subtracts the total weight from the winner, so a 5:1:1 split
  interleaves (A A B A A C A ...) instead of arriving in bursts.
- **Health weights**: each success folds its latency into a per-replica
  EWMA, and the weight is the inverse of that EWMA; the pick floors
  every weight at 1/`_MAX_SPREAD` of the fastest, so one slow reply
  cannot exile a replica.
- **Failover with probation**: a transport or server error marks the
  replica down for `probation_secs` and the request retries on the next
  pick; once probation ends the next pick redials it.
- **Draining**: an 'infer' reply's notice carries 'draining' once the
  server began its shutdown; the router stops new picks to it at once
  (the reply itself is valid), and `apply_membership` turns
  host_joined/host_left events into adds and removals.

The router never owns the wire: `connect_fn(address)` returns any
channel with `remote_infer(payload) -> (result, notice)`,
`supports_infer() -> bool` and `close()`. `connect_serving` below dials
one with a RemoteActorClient handshake on the learner's ingest listener
(offering no 'host' identity, so it stays out of the membership ledger).
"""

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis.runtime import make_lock

log = logging.getLogger('scalable_agent_tpu_torch')

_ROUTE_MS = telemetry.histogram('serving/route_ms')
_ROUTE_ERRORS = telemetry.counter('serving/route_errors')
_ROUTE_FAILOVERS = telemetry.counter('serving/route_failovers')
_ROUTE_REPLICAS = telemetry.gauge('serving/route_replicas')


class NoReplicasAvailable(RuntimeError):
  """Every replica is down, draining or departed: the caller backs off
  and retries (or infers locally); the router never blocks waiting for
  one to recover."""


class _Replica:
  """Routing state of one serving replica. Every field but `io_lock` is
  guarded by the router's lock; `io_lock` serializes the channel's
  request/reply traffic alone, so a slow infer on one replica never
  holds the pick path of the others."""

  __slots__ = ('address', 'channel', 'weight', 'current', 'ewma_ms',
               'serves', 'errors', 'draining', 'down_until', 'left',
               'io_lock')

  def __init__(self, address: str):
    self.address = address
    self.channel = None          # dialed at its first pick
    self.weight = 1.0            # inverse-EWMA health weight
    self.current = 0.0           # smooth round-robin credit
    self.ewma_ms: Optional[float] = None
    self.serves = 0
    self.errors = 0
    self.draining = False
    self.down_until = 0.0        # monotonic deadline; 0 = up
    self.left = False            # departed (membership or note_left)
    self.io_lock = make_lock('routing._Replica.io_lock')


class ServingRouter:
  """Spreads `infer` calls over serving replicas (see the module
  docstring). Thread-safe: picks and bookkeeping run under the router's
  lock, dials and the RPCs outside it (each replica's `io_lock` keeps its
  channel's framing intact)."""

  # EWMA smoothing of a replica's latency: the last ~5 calls dominate.
  _EWMA_ALPHA = 0.2
  # No replica's effective weight drops below 1/_MAX_SPREAD of the
  # fastest's: a first call's set-up cost must not starve it of the
  # traffic its EWMA needs to recover.
  _MAX_SPREAD = 10.0

  def __init__(self, addresses: Sequence[str],
               connect_fn: Callable[[str], object],
               probation_secs: float = 5.0,
               clock: Callable[[], float] = time.monotonic):
    self._connect_fn = connect_fn
    self._probation = float(probation_secs)
    self._clock = clock
    # Guards _replicas (every _Replica field but io_lock), _route_errors
    # and _route_failovers.
    self._lock = make_lock('routing.ServingRouter._lock')
    self._replicas: Dict[str, _Replica] = {}
    self._route_errors = 0
    self._route_failovers = 0
    for addr in addresses:
      self._replicas[str(addr)] = _Replica(str(addr))
    _ROUTE_REPLICAS.set(len(self._replicas))

  # -- pick / serve --

  def _available_locked(self) -> List[_Replica]:
    now = self._clock()
    return [r for r in self._replicas.values()
            if not r.left and not r.draining
            and (r.down_until == 0.0 or r.down_until <= now)]

  def _pick_locked(self) -> Optional[_Replica]:
    """Smooth weighted round-robin over the available replicas."""
    avail = self._available_locked()
    if not avail:
      return None
    floor = max(r.weight for r in avail) / self._MAX_SPREAD
    total = 0.0
    best = None
    for rep in avail:
      w = max(rep.weight, floor)
      rep.current += w
      total += w
      if best is None or rep.current > best.current:
        best = rep
    best.current -= total
    return best

  def infer(self, payload: dict) -> Tuple[dict, dict]:
    """Route one inference batch; returns (result, notice). Tries each
    available replica at most once (a failover on a transport or server
    error counts `serving/route_failovers`) and raises
    NoReplicasAvailable when the pool is exhausted. A 'draining' notice
    drains the replica after its (valid) result is returned."""
    attempts = 0
    last_err: Optional[Exception] = None
    # The walk is bounded by the pool's size at entry; each pick
    # re-evaluates availability, so a replica marked down mid-walk is not
    # retried.
    with self._lock:
      max_attempts = max(1, len(self._replicas))
    while attempts < max_attempts:
      with self._lock:
        rep = self._pick_locked()
      if rep is None:
        break
      attempts += 1
      try:
        result, notice = self._call(rep, payload)
      except (ConnectionError, OSError, RuntimeError, EOFError) as e:
        last_err = e
        self._mark_down(rep, e)
        if attempts < max_attempts:
          with self._lock:
            self._route_failovers += 1
          _ROUTE_FAILOVERS.inc()
        continue
      if notice.get('draining'):
        self.note_draining(rep.address)
      return result, notice
    raise NoReplicasAvailable(
        f'no serving replica available after {attempts} attempt(s)'
        + (f' (last error: {last_err})' if last_err else ''))

  def _call(self, rep: _Replica, payload: dict) -> Tuple[dict, dict]:
    with rep.io_lock:
      channel = rep.channel
      if channel is None:
        channel = self._connect_fn(rep.address)
        if hasattr(channel, 'supports_infer') and \
            not channel.supports_infer():
          self._close_channel(channel)
          raise RuntimeError(
              f'replica {rep.address} pre-dates wire v10 '
              '(no routed-inference capability)')
        with self._lock:
          rep.channel = channel
      t0 = self._clock()
      result, notice = channel.remote_infer(payload)
      lat_ms = (self._clock() - t0) * 1000.0
    _ROUTE_MS.observe(lat_ms)
    with self._lock:
      rep.serves += 1
      if rep.ewma_ms is None:
        rep.ewma_ms = lat_ms
      else:
        rep.ewma_ms = ((1.0 - self._EWMA_ALPHA) * rep.ewma_ms
                       + self._EWMA_ALPHA * lat_ms)
      # Normalized so a replica at <= 1 ms sits at 1.0, the weight an
      # unmeasured replica starts with: unmeasured ties the fastest, so
      # the first sub-millisecond answer cannot starve the rest before
      # they are probed.
      rep.weight = 1.0 / max(rep.ewma_ms, 1.0)
    return result, notice if isinstance(notice, dict) else {}

  def _mark_down(self, rep: _Replica, err: Exception):
    log.warning('serving replica %s failed (%s): probation %.1fs',
                rep.address, err, self._probation)
    _ROUTE_ERRORS.inc()
    with self._lock:
      rep.errors += 1
      rep.down_until = self._clock() + self._probation
      self._route_errors += 1
      channel, rep.channel = rep.channel, None
    self._close_channel(channel)

  @staticmethod
  def _close_channel(channel):
    if channel is None:
      return
    try:
      channel.close()
    except (OSError, RuntimeError):
      pass

  # -- membership --

  def add_replica(self, address: str):
    """Add (or resurrect) a replica; a departed address rejoins with
    fresh health state."""
    address = str(address)
    with self._lock:
      rep = self._replicas.get(address)
      if rep is None or rep.left:
        self._replicas[address] = _Replica(address)
      n = len([r for r in self._replicas.values() if not r.left])
    _ROUTE_REPLICAS.set(n)

  def note_draining(self, address: str):
    """Stop new picks to `address` (its drain notice)."""
    with self._lock:
      rep = self._replicas.get(str(address))
      if rep is not None and not rep.draining:
        rep.draining = True
        log.info('serving replica %s draining: removed from rotation',
                 address)

  def note_left(self, address: str):
    """Remove `address` from the pool (membership host_left)."""
    channel = None
    with self._lock:
      rep = self._replicas.get(str(address))
      if rep is not None and not rep.left:
        rep.left = True
        channel, rep.channel = rep.channel, None
      n = len([r for r in self._replicas.values() if not r.left])
    self._close_channel(channel)
    _ROUTE_REPLICAS.set(n)

  def apply_membership(self, events: Sequence[Dict],
                       address_of: Optional[Callable[[str], Optional[str]]]
                       = None):
    """Fold membership events into the pool: host_joined adds, host_left
    removes. `address_of(host_id)` maps an identity to its serving
    address (None: the host serves no traffic); without it the identity
    is the address."""
    for ev in events:
      host = ev.get('host')
      if host is None:
        continue
      addr = address_of(host) if address_of is not None else str(host)
      if addr is None:
        continue
      kind = ev.get('kind')
      if kind == 'host_joined':
        self.add_replica(addr)
      elif kind == 'host_left':
        self.note_left(addr)

  # -- introspection / lifecycle --

  def stats(self) -> Dict:
    with self._lock:
      replicas = [{
          'address': r.address,
          'serves': r.serves,
          'errors': r.errors,
          'weight': round(r.weight, 3),
          'ewma_ms': (round(r.ewma_ms, 3)
                      if r.ewma_ms is not None else None),
          'draining': r.draining,
          'left': r.left,
          'down': bool(r.down_until
                       and r.down_until > self._clock()),
      } for r in self._replicas.values()]
      return {
          'replicas': replicas,
          'available': len(self._available_locked()),
          'route_errors': self._route_errors,
          'route_failovers': self._route_failovers,
      }

  def close(self):
    with self._lock:
      channels = [r.channel for r in self._replicas.values()]
      for r in self._replicas.values():
        r.channel = None
    for channel in channels:
      self._close_channel(channel)


def connect_serving(address: str, contract,
                    connect_timeout_secs: float = 60.0,
                    wire_crc: bool = True):
  """Dial one serving replica: a RemoteActorClient handshake on the
  learner's ingest listener, offering no 'host' identity (routed fan-out
  must not read as pod growth). Raises RuntimeError against a replica
  older than protocol 10 (the router takes that as a dead pick)."""
  from scalable_agent_tpu_torch.runtime import remote
  client = remote.RemoteActorClient(
      address, connect_timeout_secs=connect_timeout_secs,
      wire_crc=wire_crc)
  try:
    client.handshake(contract)
    if not client.supports_infer():
      raise RuntimeError(
          f'replica {address} speaks protocol '
          f"{client.server_info.get('protocol')} < 10: no routed "
          'inference')
  except BaseException:
    client.close()
    raise
  return client
