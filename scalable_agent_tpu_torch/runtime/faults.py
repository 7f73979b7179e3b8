"""Deterministic fault injection, the learner-side part of the JAX
package's runtime/faults.py.

A `FaultPlan` is a seedable schedule of `Fault`s keyed by (site, event
index): each injection site keeps a monotone event counter, and a fault
fires when the counter reaches its index. The same plan on the same
workload fires the same faults in every run. The plan is installed
process-wide (`install`/`clear`); a site consults it with `fire(site)`,
which returns None at once when no plan is installed. A process started
with `SA_FAULT_PLAN` (the plan as JSON) installs it with
`install_from_env`.

The sites this port fires, each on the real code path:

  env_step          FaultyEnv (driver.make_fleet wraps each env when a
                    plan covers the site): 'raise' crashes the step, so
                    the fleet's respawn path runs; 'hang' wedges it for
                    `param` seconds.
  checkpoint_save   Checkpointer.save: the step just written is damaged
                    on disk (its files truncated to half) and LAST_GOOD
                    does not advance — a save killed mid-write; the
                    restore ladder must fall back past it.
  ckpt_bitrot       Checkpointer.save: one bit flips in the largest file
                    of the step just committed, after its digests were
                    recorded and LAST_GOOD advanced — disk rot that only
                    the digest ledger can catch.
  nan_burst         the learner loops: the step's staged batch gets NaN
                    rewards, so the loss and gradients go non-finite
                    through the real loss, and the in-step guard and the
                    health ladder must skip, roll back or halt.
  preempt_signal    the learner loops, one event per step: a fired fault
                    requests the preemption drain, SIGTERM made
                    deterministic.
  slot_exhaustion   InferenceServer._acquire_slot: the acquire takes the
                    contended path (park, or grow under 'grow'
                    admission) even with slots free; a parked waiter
                    re-checks the real free list on its next backoff
                    tick, so the detour is bounded.
  slow_learner      driver.train's loop, one event per learner step
                    before the train step: 'hang' sleeps `param`
                    seconds, so the trajectory buffer fills and the
                    actors' puts block (backpressure, buffer/put_waits)
                    instead of queueing without bound.
  replica_divergence  the fleet loop under data parallelism, one event
                    per health check with the SDC sentinel on: a fired
                    fault perturbs one replica's lane of the fingerprint
                    probe (replica `index % replicas`), so the real
                    detection -> incident -> rollback path runs.
  transport_send    RemoteActorClient._rpc (runtime/remote.py): 'drop'
                    closes the socket; 'garbage' and 'truncate' first
                    ship a frame the ingest must survive and quarantine.
                    Each raises the ConnectionError the actor host's
                    reconnect path expects.
  conn_partition    RemoteActorClient._rpc: 'blackhole' goes silent for
                    `param` seconds without closing the socket, the
                    half-open shape of a partition; the learner's idle
                    reaper must reap the connection.
  conn_delay        RemoteActorClient._rpc: 'delay' sleeps `param`
                    seconds before the send, 'jitter' a seeded
                    U[0, param].
  learner_crash     driver.train's loop, one event per consumed batch:
                    'kill' SIGKILLs the process (no unwind, no drain, no
                    'bye'), so remote actors must reattach to the
                    restarted learner.
  wire_bitflip      the OOB sends of remote.py (the unroll frames): one
                    seeded bit of the frame's largest raw buffer flips
                    after the CRC trailer was computed; the frame still
                    parses and only the learner's CRC check sees it. The
                    damaged segment is a copy, so a resend is clean.
  publish_corrupt   TrajectoryIngestServer._make_blob: one seeded bit of
                    the snapshot's largest leaf flips after its content
                    digest was computed and before serialization, so
                    only the client's digest check before install can
                    catch it.

`SITES` is the JAX package's full tuple, and the port fires every one of
them; `install` still refuses a plan with a site outside `PORTED_SITES`
rather than accept it and never fire it.

Event counters are global per site: when several actor threads share
'env_step', which thread draws the firing index depends on scheduling,
but the number and kind of faults fired is the schedule's.
"""

import dataclasses
import json
import logging
import os
import signal
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import integrity

log = logging.getLogger('scalable_agent_tpu_torch')

SITES = ('env_step', 'transport_send', 'checkpoint_save', 'nan_burst',
         'slot_exhaustion', 'preempt_signal', 'slow_learner',
         'conn_partition', 'conn_delay', 'learner_crash',
         'wire_bitflip', 'publish_corrupt', 'ckpt_bitrot',
         'replica_divergence')

# The sites this port fires (see the module docstring).
PORTED_SITES = ('checkpoint_save', 'ckpt_bitrot', 'conn_delay',
                'conn_partition', 'env_step', 'learner_crash', 'nan_burst',
                'preempt_signal', 'publish_corrupt', 'replica_divergence',
                'slot_exhaustion', 'slow_learner', 'transport_send',
                'wire_bitflip')

PLAN_ENV_VAR = 'SA_FAULT_PLAN'

# The wire's length prefix (runtime/remote.py's _LEN).
_LEN = struct.Struct('>Q')


class InjectedFault(RuntimeError):
  """An exception raised by fault injection (never by real code)."""


@dataclasses.dataclass(frozen=True)
class Fault:
  site: str    # one of SITES
  index: int   # the site's event counter value at which to fire
  kind: str    # site-specific: interrupt | flip | nan | drain | ...
  param: float = 0.0  # kind-specific

  def __post_init__(self):
    if self.site not in SITES:
      raise ValueError(f'unknown fault site {self.site!r} '
                       f'(sites: {SITES})')


class FaultPlan:
  """A deterministic schedule of faults and per-site event counters.
  Thread-safe: sites fire from the learner loop and from saves."""

  def __init__(self, faults: List[Fault], seed: int = 0):
    self._seed = int(seed)
    self._table: Dict[str, Dict[int, Fault]] = {}
    for f in faults:
      self._table.setdefault(f.site, {})[int(f.index)] = f
    self._counters: Dict[str, int] = {site: 0 for site in SITES}
    self._fired: Dict[str, int] = {site: 0 for site in SITES}
    self._lock = threading.Lock()

  @property
  def seed(self) -> int:
    return self._seed

  def faults(self) -> List[Fault]:
    return sorted((f for per in self._table.values()
                   for f in per.values()),
                  key=lambda f: (f.site, f.index))

  def covers(self, site: str) -> bool:
    """Whether any fault targets `site` (whether envs get wrapped at
    all: an uncovered site costs nothing)."""
    return bool(self._table.get(site))

  def fire(self, site: str) -> Optional[Fault]:
    """Advance `site`'s event counter; return the fault scheduled at
    the pre-advance index, if any."""
    with self._lock:
      idx = self._counters[site]
      self._counters[site] = idx + 1
      fault = self._table.get(site, {}).get(idx)
      if fault is not None:
        self._fired[site] += 1
      return fault

  def stats(self) -> Dict[str, Dict[str, int]]:
    with self._lock:
      return {site: {'events': self._counters[site],
                     'fired': self._fired[site],
                     'scheduled': len(self._table.get(site, {}))}
              for site in SITES}

  def to_json(self) -> str:
    return json.dumps({'seed': self._seed,
                       'faults': [dataclasses.asdict(f)
                                  for f in self.faults()]})

  @classmethod
  def from_json(cls, payload: str) -> 'FaultPlan':
    obj = json.loads(payload)
    return cls([Fault(**f) for f in obj['faults']],
               seed=obj.get('seed', 0))

  @classmethod
  def storm(cls, seed: int,
            env_raise_at: Optional[int] = None,
            env_hang_at: Optional[int] = None,
            env_hang_secs: float = 3.0,
            transport: Optional[List[str]] = None,
            transport_start: int = 3,
            transport_stride: int = 4,
            nan_burst_at: Optional[int] = None,
            nan_burst_len: int = 0,
            checkpoint_interrupt_at: Optional[int] = None,
            slot_exhaustion_at: Optional[int] = None,
            slot_exhaustion_len: int = 0,
            preempt_at: Optional[int] = None,
            slow_learner_at: Optional[int] = None,
            slow_learner_len: int = 0,
            slow_learner_secs: float = 0.5,
            conn_partition_at: Optional[int] = None,
            conn_partition_secs: float = 3.0,
            conn_delay: Optional[List[int]] = None,
            conn_delay_secs: float = 0.2,
            learner_crash_at: Optional[int] = None,
            wire_bitflip: Optional[List[int]] = None,
            publish_corrupt_at: Optional[int] = None,
            publish_corrupt_len: int = 1,
            ckpt_bitrot_at: Optional[int] = None,
            replica_divergence_at: Optional[int] = None,
            replica_divergence_len: int = 0
            ) -> 'FaultPlan':
    """The JAX package's scripted multi-fault storm, argument for
    argument: the schedule is a pure function of the arguments."""
    faults: List[Fault] = []
    if env_raise_at is not None:
      faults.append(Fault('env_step', env_raise_at, 'raise'))
    if env_hang_at is not None:
      faults.append(Fault('env_step', env_hang_at, 'hang',
                          param=env_hang_secs))
    for i, kind in enumerate(transport or []):
      faults.append(Fault('transport_send',
                          transport_start + i * transport_stride, kind))
    for i in range(nan_burst_len):
      faults.append(Fault('nan_burst', (nan_burst_at or 0) + i, 'nan'))
    if checkpoint_interrupt_at is not None:
      faults.append(Fault('checkpoint_save', checkpoint_interrupt_at,
                          'interrupt'))
    for i in range(slot_exhaustion_len):
      faults.append(Fault('slot_exhaustion',
                          (slot_exhaustion_at or 0) + i, 'force'))
    if preempt_at is not None:
      faults.append(Fault('preempt_signal', preempt_at, 'drain'))
    for i in range(slow_learner_len):
      faults.append(Fault('slow_learner', (slow_learner_at or 0) + i,
                          'hang', param=slow_learner_secs))
    if conn_partition_at is not None:
      faults.append(Fault('conn_partition', conn_partition_at,
                          'blackhole', param=conn_partition_secs))
    for idx in conn_delay or []:
      faults.append(Fault('conn_delay', idx, 'delay',
                          param=conn_delay_secs))
    if learner_crash_at is not None:
      faults.append(Fault('learner_crash', learner_crash_at, 'kill'))
    for idx in wire_bitflip or []:
      faults.append(Fault('wire_bitflip', idx, 'flip'))
    if publish_corrupt_at is not None:
      for i in range(max(publish_corrupt_len, 1)):
        faults.append(Fault('publish_corrupt', publish_corrupt_at + i,
                            'flip'))
    if ckpt_bitrot_at is not None:
      faults.append(Fault('ckpt_bitrot', ckpt_bitrot_at, 'flip'))
    for i in range(replica_divergence_len):
      faults.append(Fault('replica_divergence',
                          (replica_divergence_at or 0) + i, 'perturb'))
    return cls(faults, seed=seed)


# --- the process-wide plan ---

_active_lock = threading.Lock()
_active: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
  """Make `plan` the active plan (None clears it). Raises
  NotImplementedError when it schedules a fault at a site the port does
  not fire yet."""
  if plan is not None:
    unported = sorted({f.site for f in plan.faults()} - set(PORTED_SITES))
    if unported:
      raise NotImplementedError(
          f'fault sites {unported} are not fired by the PyTorch port; it '
          f'fires {list(PORTED_SITES)}')
  global _active
  with _active_lock:
    _active = plan


def clear() -> None:
  install(None)


def active() -> Optional[FaultPlan]:
  return _active


def install_from_env() -> Optional[FaultPlan]:
  """Install the plan serialized in SA_FAULT_PLAN, if any."""
  payload = os.environ.get(PLAN_ENV_VAR)
  if not payload:
    return None
  plan = FaultPlan.from_json(payload)
  install(plan)
  return plan


def fire(site: str) -> Optional[Fault]:
  """Consult the active plan; None when no plan is installed."""
  plan = _active
  if plan is None:
    return None
  return plan.fire(site)


# --- site: env_step ---


class FaultyEnv:
  """An env wrapper that consults the plan on every step.

  'raise' raises an InjectedFault out of env.step, the shape of an env
  crash (the fleet's respawn path runs). 'hang' sleeps `param` seconds
  inside the step, the shape of a wedged simulator (the heartbeat goes
  stale). Unknown kinds fall through to the plain step."""

  def __init__(self, env):
    self._env = env

  def initial(self):
    return self._env.initial()

  def step(self, action):
    fault = fire('env_step')
    if fault is not None:
      if fault.kind == 'raise':
        raise InjectedFault('env_step: injected crash')
      if fault.kind == 'hang':
        time.sleep(float(fault.param))
    return self._env.step(action)

  def close(self):
    return self._env.close()

  def __getattr__(self, name):
    return getattr(self._env, name)


def maybe_wrap_env(env):
  """`env` wrapped in a FaultyEnv iff the active plan targets env_step;
  otherwise `env` itself."""
  plan = _active
  if plan is not None and plan.covers('env_step'):
    return FaultyEnv(env)
  return env


# --- site: slow_learner ---


def maybe_slow_learner() -> Optional[float]:
  """Consult the slow_learner site once (one learner step, one event);
  a fired 'hang' sleeps its seconds here. Returns the seconds slept, or
  None."""
  fault = fire('slow_learner')
  if fault is None or fault.kind != 'hang':
    return None
  secs = float(fault.param)
  log.warning('slow_learner fault: the learner sleeps %.2f s', secs)
  time.sleep(secs)
  return secs


# --- sites: checkpoint_save and ckpt_bitrot ---


def _step_dir(directory: str, step: int) -> str:
  for name in os.listdir(directory):
    path = os.path.join(directory, name)
    if os.path.isdir(path) and (name == str(step)
                                or name.split('.')[-1] == str(step)):
      return path
  raise FileNotFoundError(
      f'no step directory for step {step} under {directory}')


def corrupt_checkpoint_step(directory: str, step: int) -> List[str]:
  """A save killed mid-write: every file of the step's directory of 32
  bytes or more is truncated to half its size (the step still lists as
  the newest). Returns the damaged paths."""
  damaged = []
  for root, _, files in os.walk(_step_dir(directory, step)):
    for fname in files:
      fpath = os.path.join(root, fname)
      size = os.path.getsize(fpath)
      if size >= 32:
        with open(fpath, 'r+b') as f:
          f.truncate(size // 2)
        damaged.append(fpath)
  return damaged


def bitrot_checkpoint_step(directory: str, step: int,
                           seed: int = 0) -> str:
  """Flip one bit at a seeded offset of the largest file of a committed
  step: disk rot after the save verified. Returns the damaged path."""
  candidates = []
  for root, _, files in os.walk(_step_dir(directory, step)):
    for fname in files:
      fpath = os.path.join(root, fname)
      candidates.append((os.path.getsize(fpath), fpath))
  if not candidates:
    raise FileNotFoundError(f'step {step} directory is empty')
  size, target = max(candidates)
  rng = np.random.RandomState((seed + step) % (2 ** 31))
  offset = int(rng.randint(0, max(size, 1)))
  with open(target, 'r+b') as f:
    f.seek(offset)
    byte = bytearray(f.read(1) or b'\x00')
    integrity.flip_bit(byte, int(rng.randint(0, 8)))
    f.seek(offset)
    f.write(bytes(byte))
  log.warning('ckpt_bitrot fault: flipped one bit at offset %d of %s',
              offset, target)
  return target


# --- site: nan_burst ---


def poison_batch(batch):
  """`batch` with NaN rewards (on the batch's device): a non-finite
  loss and gradients through the real loss, as organic divergence
  looks to the health ladder."""
  env_outputs = batch.env_outputs._replace(
      reward=torch.full_like(batch.env_outputs.reward, float('nan')))
  return batch._replace(env_outputs=env_outputs)


def maybe_poison_batch(batch):
  """Consult the nan_burst site once (one learner step, one event);
  returns (batch, poisoned)."""
  if fire('nan_burst') is not None:
    return poison_batch(batch), True
  return batch, False


# --- site: transport_send ---


def apply_transport_fault(fault: Fault, sock: socket.socket,
                          seed: int = 0) -> None:
  """Damage `sock` per `fault`, close it and raise ConnectionError.
  'garbage' ships a well-framed message of 256 seeded random bytes (the
  receiver must fail the parse and quarantine the connection);
  'truncate' claims four times the 128 bytes it sends (the receiver
  sees EOF mid-message); 'drop' and unknown kinds send nothing."""
  try:
    if fault.kind == 'garbage':
      rng = np.random.RandomState((seed + fault.index) % (2 ** 31))
      payload = rng.bytes(256)
      sock.sendall(_LEN.pack(len(payload)) + payload)
    elif fault.kind == 'truncate':
      rng = np.random.RandomState((seed + fault.index) % (2 ** 31))
      payload = rng.bytes(128)
      sock.sendall(_LEN.pack(len(payload) * 4) + payload)
  except OSError:
    pass  # the peer may be gone already; the raise below still runs
  try:
    sock.close()
  except OSError:
    pass
  raise ConnectionError(
      f'injected transport fault: {fault.kind} (index {fault.index})')


# --- sites: conn_partition and conn_delay ---


def apply_conn_partition(fault: Fault) -> None:
  """Blackhole the caller for `fault.param` seconds: no send, no recv,
  no close, so the peer's socket stays established with nothing
  flowing. The caller then goes on and finds what the other side did
  meanwhile (an idle reap shows on its next send)."""
  time.sleep(float(fault.param))


def apply_conn_delay(fault: Fault, seed: int = 0) -> float:
  """Transport latency: 'delay' sleeps exactly `param` seconds,
  'jitter' a seeded U[0, param]. Returns the seconds slept."""
  if fault.kind == 'jitter':
    rng = np.random.RandomState((seed + fault.index) % (2 ** 31))
    secs = float(rng.uniform(0.0, float(fault.param)))
  else:
    secs = float(fault.param)
  time.sleep(secs)
  return secs


# --- site: learner_crash ---


def hard_crash(fault: Fault) -> None:
  """SIGKILL this process: no exception unwind, no finally block, no
  drain, no 'bye' frame (the OOM-killer shape). Logged first, so a
  scheduled crash is told from an organic one."""
  log.error('learner_crash fault firing (index %d): hard-killing pid %d',
            fault.index, os.getpid())
  os.kill(os.getpid(), signal.SIGKILL)


# --- site: wire_bitflip ---


def apply_wire_bitflip(fault: Fault, segments, seed: int = 0):
  """One seeded bit flip in the largest raw-buffer segment of an
  outgoing OOB frame (segments[1:]; segment 0 is the frame's head).
  Returns a new segment list whose damaged segment is a copy, so the
  sender's unroll is never touched. A frame with no raw buffer passes
  unchanged."""
  if len(segments) < 2:
    return segments
  idx = max(range(1, len(segments)),
            key=lambda i: memoryview(segments[i]).nbytes)
  damaged = bytearray(segments[idx])
  rng = np.random.RandomState((seed + fault.index) % (2 ** 31))
  byte, bit = integrity.flip_bit(
      damaged, int(rng.randint(0, max(len(damaged) * 8, 1))))
  log.warning('wire_bitflip fault firing (index %d): flipped bit %d of '
              'byte %d in a %d-byte frame segment', fault.index, bit, byte,
              len(damaged))
  return list(segments[:idx]) + [memoryview(damaged)] + list(
      segments[idx + 1:])


# --- site: publish_corrupt ---


def corrupt_params_tree(fault: Fault, params, seed: int = 0):
  """`params` (a wire-form tree, runtime/codec.py) with one seeded bit
  flipped in its largest leaf, in the JAX package's flatten order; the
  other leaves are the input's."""
  from scalable_agent_tpu_torch.runtime import codec
  leaves = codec.wire_leaves(params)
  candidates = [i for i, leaf in enumerate(leaves)
                if np.asarray(leaf).size > 0]
  if not candidates:
    return params
  victim = max(candidates, key=lambda i: np.asarray(leaves[i]).nbytes)
  arr = np.array(leaves[victim], copy=True)
  raw = bytearray(arr.tobytes())
  rng = np.random.RandomState((seed + fault.index) % (2 ** 31))
  integrity.flip_bit(raw, int(rng.randint(0, len(raw) * 8)))
  leaves = list(leaves)
  leaves[victim] = np.frombuffer(bytes(raw),
                                 dtype=arr.dtype).reshape(arr.shape)
  log.warning('publish_corrupt fault firing (index %d): flipped one bit '
              'in a %d-byte param leaf after digest', fault.index,
              len(raw))
  return codec.wire_rebuild(params, leaves)
