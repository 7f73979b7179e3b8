"""Batched inference server: many actor threads, one batched agent call on
the device, ported from the JAX package's runtime/inference.py.

- Actor threads call `policy(prev_action, env_output, core_state)` (the
  `runtime.actor.Actor` contract) and block.
- The C++ batcher (ops/dynamic_batching.py) merges concurrent calls; its
  merge copy lands in pinned staging buffers, padded to a power-of-two
  bucket (`_padded_size`, floored at `pad_batch_to` when given: an
  evaluation server warms and serves one bucket).
- A dispatch thread copies the merged batch to the device on the
  server's own stream, runs the single-step agent, and copies the outputs
  back into pinned buffers behind an event; a completion thread waits on
  the event and unparks the callers. At most `inference_pipeline_depth`
  batches are dispatched and not completed, so batch k+1 assembles and
  lands while batch k computes. On the CPU every step is synchronous.
- Actions are sampled from one `torch.Generator` on the device, used by
  the dispatch thread only. A forward that raises leaves the generator
  (and the state arena) as they were before the call (`_recover_chain`),
  so a retried call draws what it would have drawn.

The state arena (`inference_state_cache`). Instead of shipping the LSTM
carry host->device and the new carry back on every actor step, each
actor owns a slot of a `[slots, hidden]` float32 pair on the device; the
forward gathers each row's carry by slot id, runs the T=1 step, and
scatters the new carry back, so only the slot id rides the wire and the
carry crosses once per unroll (`_SlotHandle.snapshot()`, the learner's
unroll-start state). The arena has one row past its slots: padded rows
(slot id `_PAD_SLOT_ID`, out of range for any arena size, grown or not)
gather from and scatter into that row, never into a live slot. Every
arena operation (the dispatch's gather and scatter, a snapshot's read,
a slot's zeroing and write, a grow's copy) is issued under the arena
lock on the server's stream, so each is ordered after the last scatter
into the slot on the device, and a grow's copy takes the scatters of
every dispatch issued before it. The outputs are numerically those of
the carry path on the same merged batch.

Admission. A slot is acquired at actor (re)spawn (`initial_core_state`)
under `inference_admission`: `block` parks the caller on a priority
waitlist (PRIORITY_LIVE < PRIORITY_RESPAWN < PRIORITY_EVAL; a released
slot is handed to the best waiter directly) until a slot frees or
`inference_admission_timeout_secs` passes (then SlotUnavailable);
`shed` the same, with the deadline's rejection counted as a shed;
`grow` doubles the arena instead of parking. `close()` answers every
parked waiter with InferenceClosed. The `slot_exhaustion` fault site
forces an acquire down the contended path.

Weights: the version table. Each published version is an entry holding
its own copy on the device (a *snapshot*: an agent copy, or with
`publish_codec='int8'` int8 values and a scale per tensor, runtime/
codec.py, dequantized inside the serving forward), taken by
`update_params` on the publisher's current stream (the learner's), so
the copy is ordered after the step that produced the params and before
the learner's next in-place update, and an event marks it complete. The
dispatch stream waits on that event before it reads a snapshot. Up to
`serving_resident_versions` entries stay resident (LRU eviction of
unpinned, non-live entries, also down to `serving_hbm_budget_mb`);
re-publishing a resident version flips live to it without a copy, and
re-publishing the live version is skipped. `serving_ab_fraction` of the
merged calls are served by the A/B candidate, and
`serving_shadow_fraction` are replayed against the shadow version by a
pure step (greedy, no generator draw, no arena scatter) before the live
step, scored on greedy-action agreement (`shadow_divergence`). An
evicted snapshot's storage is reused for a later publish only once no
dispatch holds it and the last dispatch that read it has completed on
the device; until then a new one is made. As in the reference, the
actions of one unroll may span weight versions.

`serving_aot`. The JAX package compiles a serving program per (bucket,
parameter structure) ahead of time, at publish, so a flip to a new
structure pays no compile on the serve path. Eager PyTorch has no
compile to move off the serve path; what a new structure's first call
does pay is its first-use set-up (cuDNN algorithm choice, allocator
growth). So the port accepts the flag and, at the publish of a new
structure (an int8 entry after float32 ones), runs one warm forward per
warmed bucket on a scratch generator; `aot_misses` counts the serves of
a (bucket, structure) pair that was not warmed.

Routed serving (`serve_remote`). driver.train attaches it to the remote
ingest's 'infer' kind (runtime/remote.py), which actor hosts reach
through a `runtime/routing.ServingRouter`. A routed batch is carry-
passing even on a state-arena server (the remote caller owns its carry:
no slot is taken or written), is served by the version table's live (or
A/B) entry, int8 entries included, and samples from a generator of its
own, seeded apart from the fleet's and advanced per call, so routed
traffic never moves the local fleet's random sequence. Its batch sizes
are the caller's, not the warmed buckets: a size's first call pays its
first-use set-up.
"""

import collections
import contextlib
import copy
import logging
import queue
import threading
import time

import numpy as np
import torch

from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis.runtime import guarded_by, make_lock
from scalable_agent_tpu_torch.config import validate_fleet
from scalable_agent_tpu_torch.observability import LatencyReservoir
from scalable_agent_tpu_torch.ops import dynamic_batching
from scalable_agent_tpu_torch.runtime import codec as codec_lib
from scalable_agent_tpu_torch.runtime import faults as faults_lib
from scalable_agent_tpu_torch.runtime.fleet import Backoff
from scalable_agent_tpu_torch.structs import AgentOutput, StepOutput

log = logging.getLogger('scalable_agent_tpu_torch')

# The serving plane's registry metrics: merged-call latency, the version
# table's flips, evictions and residents, A/B and shadow calls, and the
# serves no warm forward covered.
_SERVE_LATENCY = telemetry.histogram('serving/latency_ms')
_SHADOW_DIVERGENCE = telemetry.gauge('serving/shadow_divergence')
_SHADOW_CALLS = telemetry.counter('serving/shadow_calls')
_AB_CALLS = telemetry.counter('serving/ab_calls')
_EVICTIONS = telemetry.counter('serving/evictions')
_VERSION_FLIPS = telemetry.counter('serving/version_flips')
_RESIDENT_VERSIONS = telemetry.gauge('serving/resident_versions')
_AOT_MISSES = telemetry.counter('serving/aot_misses')

# Admission priority classes (lower is served first): a released slot
# goes to the best-priority parked waiter, so respawn and eval churn
# cannot starve live actors.
PRIORITY_LIVE = 0
PRIORITY_RESPAWN = 1
PRIORITY_EVAL = 2

ADMISSION_POLICIES = ('block', 'shed', 'grow')

# The slot id of a padded merge row: out of range for any arena size,
# also after a grow between staging and dispatch.
_PAD_SLOT_ID = np.int32(1 << 30)

# Inputs of one merged call, in the batcher's tensor order.
_CARRY_INPUTS = ('prev_action', 'reward', 'done', 'frame', 'instr',
                 'core_c', 'core_h')
_CACHE_INPUTS = ('slot_id', 'prev_action', 'reward', 'done', 'frame',
                 'instr')
# A routed batch's dtypes, in _CARRY_INPUTS order (serve_remote).
_REMOTE_DTYPES = (np.int32, np.float32, bool, np.uint8, np.int32, np.float32,
                  np.float32)


class SlotUnavailable(RuntimeError):
  """No state-arena slot was admitted before the deadline (shed: the
  intended overload response; block: the bounded wait's backstop). The
  fleet treats it as pause-and-retry."""


class InferenceClosed(RuntimeError):
  """The server closed while the caller was parked on the admission
  waitlist."""


class _Waiter:
  """One parked acquire: priority and FIFO tiebreak, the event a release
  sets on a direct handoff, and the closed flag `close()` sets."""

  __slots__ = ('priority', 'seq', 'event', 'slot', 'closed')

  def __init__(self, priority, seq):
    self.priority = priority
    self.seq = seq
    self.event = threading.Event()
    self.slot = None
    self.closed = False


def _next_power_of_two(n):
  p = 1
  while p < n:
    p *= 2
  return p


def percentile_ms(sorted_ms, q):
  """q-th percentile of an ascending list (nearest rank, clamped)."""
  if not sorted_ms:
    return 0.0
  return sorted_ms[min(len(sorted_ms) - 1, int(len(sorted_ms) * q))]


class _SlotHandle:
  """An actor's claim on one state-arena slot, opaque under the Actor's
  core-state contract: `snapshot()` reads the slot's carry to the host
  as (c [1, H], h [1, H]) numpy, `write(carry)` overwrites it (the
  actor's priming-call undo), `release()` returns the slot (idempotent;
  the slot is zeroed at its next acquire)."""

  __slots__ = ('_server', 'slot', 'released')

  def __init__(self, server, slot):
    self._server = server
    self.slot = slot
    self.released = False

  def snapshot(self):
    if self.released:
      # A released slot may already serve its next owner.
      raise RuntimeError('snapshot() on a released state slot')
    return self._server._read_slot(self.slot)

  def write(self, carry):
    if self.released:
      raise RuntimeError('write() on a released state slot')
    self._server._write_slot(self.slot, carry)

  def release(self):
    if not self.released:
      self.released = True
      self._server._release_slot(self.slot)

  def __repr__(self):
    return f'_SlotHandle(slot={self.slot}, released={self.released})'


class _Snapshot:
  """The device storage of one resident version: an agent copy
  (`kind` 'f32'), or int8 values and scales by parameter name ('int8');
  the kind is the parameter structure a serving_aot warm forward covers;
  the event its copy completes at, the dispatches holding it, and the
  event of the last dispatch that read it."""

  def __init__(self, kind, agent=None, params=None):
    self.kind = kind
    self.agent = agent
    self.params = (dict(agent.named_parameters()) if agent is not None
                   else params)
    self.nbytes = codec_lib.tree_nbytes(self.params)
    self.ready = None      # torch.cuda.Event (None on the CPU)
    self.inflight = 0
    self.last_use = None   # torch.cuda.Event (None on the CPU)


class _VersionEntry:
  """One resident version: its publish key, snapshot, pin flag, serve
  count and LRU tick."""

  __slots__ = ('key', 'snapshot', 'pinned', 'serves', 'tick')

  def __init__(self, key, snapshot, tick):
    self.key = key
    self.snapshot = snapshot
    self.pinned = False
    self.serves = 0
    self.tick = tick

  def label(self):
    """The stats() key: the numeric publish version, 'anon-N' for a
    publish without one, '<seed>' for the constructor's entry."""
    if isinstance(self.key, int):
      return self.key
    if isinstance(self.key, tuple) and self.key and self.key[0] == 'anon':
      return f'anon-{self.key[1]}'
    return '<seed>'


class _Staging:
  """Pinned host buffers of one ring slot of a padded bucket: the merged
  inputs (the batcher copies into `inputs`), the outputs (the device
  copies back into `out_tensors`) and the shadow step's logits."""

  def __init__(self, padded, in_meta, out_meta, num_actions, pin):
    # Zeroed: the rows past a batch's size are computed too, and must
    # hold valid inputs (an action id in range) from the start.
    def zeros(shape, dtype):
      return torch.zeros(shape, dtype=dtype, pin_memory=pin)
    self.in_tensors = [
        zeros((padded,) + tuple(trail),
              torch.from_numpy(np.empty(0, dtype)).dtype)
        for dtype, trail in in_meta]
    self.inputs = [t.numpy() for t in self.in_tensors]
    self.out_tensors = [zeros((padded,) + trail, dtype)
                        for trail, dtype in out_meta]
    self.shadow_logits = zeros((padded, num_actions), torch.float32)
    self.nbytes_in = sum(t.numel() * t.element_size()
                         for t in self.in_tensors)
    self.nbytes_out = sum(t.numel() * t.element_size()
                          for t in self.out_tensors)


class InferenceServer:
  """Serves a batched policy to host actor threads.

  Args:
    agent: an ImpalaAgent; the server keeps copies of it on `device` (its
      own parameter tensors), never the learner's module.
    params: the initial parameters by name (the learner's
      `TrainState.params`); copied.
    config: Config (the inference_*, serving_* and publish_codec fields;
      validate_fleet's checks).
    seed: seed of the action-sampling generator.
    fleet_size: the number of actor threads served: the merge floor when
      config.inference_min_batch == 0 (AUTO), and the arena's auto size.
    device: where inference runs (default: the params' device).
    pad_batch_to: a floor on the padded batch size (evaluation: every
      level steps at once, so one bucket serves every merged call).
  """

  # Lock discipline (the guarded-by checker, analysis/concurrency.py).
  # JAX's class holds its version table under _params_lock, its counters
  # under _stats_lock and its warm-up state under _aot_lock; here `_lock`
  # (named 'inference._params_lock') holds all three roles. Where locks nest:
  # _slot_lock -> _arena_lock and _slot_lock -> _lock (admission), _lock
  # is taken alone otherwise. JAX's four other annotations have no
  # counterpart: `_aot` (its AOT executable table; serving_aot here runs
  # warm forwards, `_warmed`), `_remote_calls` and `_key` (counters of
  # its PRNG keys; the port draws from torch.Generators) and
  # `_devices_last_call` (its mesh's device count per call).
  _versions: guarded_by('_lock')
  _live_key: guarded_by('_lock')
  _serve_tick: guarded_by('_lock')
  _anon_seq: guarded_by('_lock')
  _ab_fraction: guarded_by('_lock')
  _ab_key: guarded_by('_lock')
  _ab_acc: guarded_by('_lock')
  _shadow_fraction: guarded_by('_lock')
  _shadow_key: guarded_by('_lock')
  _shadow_acc: guarded_by('_lock')
  _warm_meta: guarded_by('_lock')
  _warm_buckets: guarded_by('_lock')
  _arena: guarded_by('_arena_lock')
  _free: guarded_by('_slot_lock')
  _waiters: guarded_by('_slot_lock')
  _waiter_seq: guarded_by('_slot_lock')
  _closed: guarded_by('_slot_lock')
  _admission: guarded_by('_slot_lock')
  # The grow path swaps the arena (and its size) holding both
  # _slot_lock and _arena_lock, so readers under either are safe.
  _num_slots: guarded_by('_slot_lock', '_arena_lock')
  _calls: guarded_by('_lock')
  _merged_requests: guarded_by('_lock')
  _params_version: guarded_by('_lock')
  _publishes_skipped: guarded_by('_lock')
  _inflight: guarded_by('_lock')
  _inflight_peak: guarded_by('_lock')
  _acquires: guarded_by('_lock')
  _admission_waits: guarded_by('_lock')
  _sheds: guarded_by('_lock')
  _admission_timeouts: guarded_by('_lock')
  _arena_grows: guarded_by('_lock')
  _unjoined_threads: guarded_by('_lock')
  _latencies: guarded_by('_lock')
  _chain_recoveries: guarded_by('_lock')
  _version_flips: guarded_by('_lock')
  _evictions: guarded_by('_lock')
  _ab_calls: guarded_by('_lock')
  _shadow_calls: guarded_by('_lock')
  _shadow_divergence: guarded_by('_lock')
  _aot_misses: guarded_by('_lock')
  # The port's own shared state: the transfer counters, the snapshot
  # pool, the warmed (bucket, structure) pairs and the admission-wait
  # reservoir.
  _h2d_bytes: guarded_by('_lock')
  _d2h_bytes: guarded_by('_lock')
  _snapshots: guarded_by('_lock')
  _retired: guarded_by('_lock')
  _warmed: guarded_by('_lock')
  _admission_wait_reservoir: guarded_by('_lock')

  def __init__(self, agent, params, config, seed=0, fleet_size=None,
               device=None, pad_batch_to=None):
    validate_fleet(config)
    self._device = torch.device(
        device if device is not None else next(iter(params.values())).device)
    self._cuda = self._device.type == 'cuda'
    min_batch = config.inference_min_batch
    if min_batch == 0:
      min_batch = max(fleet_size or 1, 1)
    self._min_batch = min(min_batch, config.inference_max_batch)
    self._max_batch = config.inference_max_batch
    self._pad_floor = pad_batch_to
    self._depth = max(1, int(config.inference_pipeline_depth))
    self._num_actions = agent.num_actions
    self._hidden = agent.hidden_size
    self._template = copy.deepcopy(agent).to(self._device).eval()
    self._template.requires_grad_(False)
    self._template_lock = make_lock('inference._template_lock')
    self._state_cache = bool(config.inference_state_cache)
    self._admission = config.inference_admission
    self._admission_timeout = float(config.inference_admission_timeout_secs)

    self._stream = torch.cuda.Stream(self._device) if self._cuda else None
    self._generator = torch.Generator(self._device).manual_seed(seed)
    # Routed serving's own generator (the JAX server's dedicated base key,
    # seed + 424_243), advanced by each serve_remote call under its lock.
    self._remote_lock = make_lock('inference._remote_lock')
    self._remote_generator = torch.Generator(self._device).manual_seed(
        seed + 424_243)
    # The version table and the stats: what the JAX server splits
    # between _params_lock and _stats_lock, under its name.
    self._lock = make_lock('inference._params_lock')
    self._snapshots = []           # every snapshot made (for stats)
    self._retired = collections.deque()
    # The version table.
    self._resident_cap = max(1, int(config.serving_resident_versions))
    self._budget_bytes = int(float(config.serving_hbm_budget_mb) * 1e6)
    self._quantize = config.publish_codec == 'int8'
    self._versions = collections.OrderedDict()
    self._serve_tick = 0
    self._anon_seq = 0
    self._ab_fraction = float(config.serving_ab_fraction)
    self._ab_key = None       # None: the newest non-live resident
    self._ab_acc = 0.0
    self._shadow_fraction = float(config.serving_shadow_fraction)
    self._shadow_key = None
    self._shadow_acc = 0.0
    self._serving_aot = bool(config.serving_aot)
    self._warm_meta = None       # obs_spec of warmup
    self._warm_buckets = set()   # padded sizes warmed
    self._warmed = set()         # (padded, structure) warmed
    # Counters.
    self._params_version = 0
    self._publishes_skipped = 0
    self._version_flips = 0
    self._evictions = 0
    self._ab_calls = 0
    self._shadow_calls = 0
    self._shadow_divergence = 0.0
    self._aot_misses = 0
    self._calls = 0
    self._merged_requests = 0
    self._h2d_bytes = 0
    self._d2h_bytes = 0
    self._inflight = 0
    self._inflight_peak = 0
    self._chain_recoveries = 0
    self._acquires = 0
    self._admission_waits = 0
    self._sheds = 0
    self._admission_timeouts = 0
    self._arena_grows = 0
    self._admission_wait_reservoir = LatencyReservoir(maxlen=1024)
    self._latencies = collections.deque(maxlen=512)
    self._unjoined_threads = 0
    seed_key = object()
    snapshot = self._copy_into(self._new_snapshot('f32'), params)
    self._versions[seed_key] = _VersionEntry(seed_key, snapshot, 0)
    self._live_key = seed_key

    # The state arena; lock order where nested: _slot_lock ->
    # _arena_lock, _slot_lock -> _lock.
    self._slot_lock = make_lock('inference._slot_lock')
    self._arena_lock = make_lock('inference._arena_lock')
    self._waiters = []
    self._waiter_seq = 0
    self._closed = False
    self._num_slots = 0
    self._free = []
    self._arena = None
    if self._state_cache:
      num_slots = int(config.inference_state_slots)
      if num_slots <= 0:
        # Auto: respawn headroom over the fleet (a wedged actor's slot
        # frees only when its orphaned thread unwinds), with a floor
        # that covers an eval server sized by pad_batch_to.
        num_slots = max(2 * max(fleet_size or 0, pad_batch_to or 0), 8)
      self._num_slots = num_slots
      self._free = list(range(num_slots))
      with self._on_stream():
        self._arena = self._zero_arena(num_slots)

    self._staging = {}        # padded size -> ring of _Staging
    self._staging_calls = {}  # padded size -> calls (ring index)
    self._batcher = dynamic_batching.Batcher(
        num_tensors=len(_CACHE_INPUTS if self._state_cache
                        else _CARRY_INPUTS),
        minimum_batch_size=self._min_batch,
        maximum_batch_size=config.inference_max_batch,
        timeout_ms=config.inference_timeout_ms)
    self._sem = threading.Semaphore(self._depth)
    self._completion_q = queue.Queue()
    self._dispatch_thread = threading.Thread(
        target=self._dispatch_loop, name='inference-dispatch', daemon=True)
    self._completion_thread = threading.Thread(
        target=self._completion_loop, name='inference-completion',
        daemon=True)
    self._dispatch_thread.start()
    self._completion_thread.start()

  def _on_stream(self):
    """The server's stream as the current one (a no-op on the CPU)."""
    if not self._cuda:
      return contextlib.nullcontext()
    return torch.cuda.stream(self._stream)

  def _zero_arena(self, num_slots):
    """(c, h) [num_slots + 1, hidden]: the last row takes padded rows."""
    return tuple(torch.zeros((num_slots + 1, self._hidden),
                             dtype=torch.float32, device=self._device)
                 for _ in range(2))

  # -- the state arena and admission --

  def initial_core_state(self, priority=PRIORITY_LIVE):
    """The policy state of one actor, taken at each (re)spawn: a zeroed
    host carry (c, h), [1, hidden] each, on the carry path; an acquired
    (zeroed) arena slot in state-cache mode, admitted at `priority`."""
    if not self._state_cache:
      return tuple(np.zeros((1, self._hidden), np.float32)
                   for _ in range(2))
    return self._acquire_slot(priority=priority)

  @property
  def admission(self) -> str:
    with self._slot_lock:
      return self._admission

  def set_admission(self, mode: str) -> str:
    """Switch the admission policy for every acquire that has not chosen
    its path yet; callers already parked keep their deadline. Returns
    the previous mode."""
    if mode not in ADMISSION_POLICIES:
      raise ValueError(f'unknown inference_admission {mode!r} '
                       f'(policies: {ADMISSION_POLICIES})')
    with self._slot_lock:
      old, self._admission = self._admission, mode
    if old != mode:
      log.warning('inference admission policy: %s -> %s', old, mode)
    return old

  def _acquire_slot(self, priority=PRIORITY_LIVE):
    """Admit one slot under the policy: a free slot when nobody is
    parked ahead, else grow (grow) or park on the waitlist (block,
    shed). Raises SlotUnavailable at the deadline, InferenceClosed when
    the server closes. A fired `slot_exhaustion` fault takes the
    contended path even with slots free (the parked waiter re-checks the
    free list on its next backoff tick)."""
    forced = faults_lib.fire('slot_exhaustion') is not None
    waiter = None
    with self._slot_lock:
      if self._closed:
        raise InferenceClosed('inference server is closed')
      with self._lock:
        self._acquires += 1
      if not forced and self._free and not self._waiters:
        slot = self._free.pop()
      elif self._admission == 'grow':
        if forced or not self._free:
          self._grow_arena_locked()
        slot = self._free.pop()
      else:
        self._waiter_seq += 1
        waiter = _Waiter(priority, self._waiter_seq)
        self._waiters.append(waiter)
        with self._lock:
          self._admission_waits += 1
    if waiter is not None:
      slot = self._wait_for_slot(waiter)
    self._zero_slot(slot)
    return _SlotHandle(self, slot)

  def _best_waiter_locked(self):
    return min(self._waiters, key=lambda w: (w.priority, w.seq))

  def _wait_for_slot(self, waiter):
    """Park until a released slot is handed over, the server closes or
    the deadline passes; the wait re-checks the free list on a capped,
    jittered backoff."""
    t0 = time.monotonic()
    deadline = t0 + self._admission_timeout
    backoff = Backoff(base=0.02, cap=0.5)
    while True:
      remaining = deadline - time.monotonic()
      if remaining > 0:
        waiter.event.wait(timeout=min(backoff.next_delay() + 1e-3,
                                      remaining))
      with self._slot_lock:
        if waiter.slot is not None:
          slot = waiter.slot
          break
        if waiter.closed or self._closed:
          if waiter in self._waiters:
            self._waiters.remove(waiter)
          raise InferenceClosed(
              'inference server closed while waiting for a state slot')
        if self._free and self._best_waiter_locked() is waiter:
          self._waiters.remove(waiter)
          slot = self._free.pop()
          break
        if time.monotonic() >= deadline:
          self._waiters.remove(waiter)
          shed = self._admission == 'shed'
          with self._lock:
            if shed:
              self._sheds += 1
            else:
              self._admission_timeouts += 1
          raise SlotUnavailable(
              f'{"shed" if shed else "admission timeout"}: no state-'
              f'arena slot free within {self._admission_timeout:.1f}s '
              f'({self._num_slots} slots, {len(self._waiters)} other '
              'waiter(s)); raise --inference_state_slots, or pick '
              '--inference_admission=grow')
    with self._lock:
      self._admission_wait_reservoir.record(time.monotonic() - t0)
    return slot

  def _grow_arena_locked(self):
    """Double the arena (grow admission; _slot_lock held). Slot ids and
    carries are kept: the copy is issued on the server's stream after
    every dispatch issued before it, so their scatters land in the arena
    that survives."""
    with self._arena_lock, self._on_stream():
      old = self._num_slots
      new = 2 * old if old else 8
      arena = self._zero_arena(new)
      for grown, kept in zip(arena, self._arena):
        grown[:old].copy_(kept[:old])
      self._arena = arena
      self._num_slots = new
    self._free.extend(range(old, new))
    with self._lock:
      self._arena_grows += 1
    log.warning('inference state arena grown %d -> %d slots '
                '(--inference_admission=grow)', old, new)

  def _release_slot(self, slot):
    with self._slot_lock:
      if self._waiters:
        # A direct handoff: the slot never reaches the free list, so no
        # lower-priority waiter or fresh acquire can take it.
        waiter = self._best_waiter_locked()
        self._waiters.remove(waiter)
        waiter.slot = slot
        waiter.event.set()
      else:
        self._free.append(slot)

  def _zero_slot(self, slot):
    with self._arena_lock, self._on_stream():
      for a in self._arena:
        a[slot].zero_()

  def _read_slot(self, slot):
    with self._arena_lock, self._on_stream():
      host = torch.empty((2, self._hidden), dtype=torch.float32,
                         pin_memory=self._cuda)
      for row, a in zip(host, self._arena):
        row.copy_(a[slot], non_blocking=self._cuda)
      event = None
      if self._cuda:
        event = torch.cuda.Event()
        event.record(self._stream)
    if event is not None:
      event.synchronize()
    with self._lock:
      self._d2h_bytes += host.numel() * host.element_size()
    return tuple(host[i].numpy()[None].copy() for i in range(2))

  def _write_slot(self, slot, carry):
    values = [torch.from_numpy(np.asarray(c, np.float32).reshape(-1))
              for c in carry]
    with self._arena_lock, self._on_stream():
      for a, value in zip(self._arena, values):
        a[slot].copy_(value)
    with self._lock:
      self._h2d_bytes += sum(v.numel() * 4 for v in values)

  def slots_free(self):
    with self._slot_lock:
      return len(self._free)

  # -- the version table --

  def _new_snapshot(self, kind):
    if kind == 'f32':
      snapshot = _Snapshot(kind, agent=copy.deepcopy(self._template))
    else:
      snapshot = _Snapshot(kind, params={
          name: codec_lib.Int8Leaf(
              torch.empty(p.shape, dtype=torch.int8, device=self._device),
              torch.empty((), dtype=torch.float32, device=self._device))
          for name, p in self._template.named_parameters()})
    with self._lock:
      self._snapshots.append(snapshot)
    return snapshot

  def _reusable_snapshot(self, kind):
    """A retired snapshot of `kind` no dispatch holds, its last read
    complete on the device; a new one when every such one is held."""
    with self._lock:
      for snapshot in self._retired:
        if snapshot.kind == kind and snapshot.inflight == 0:
          self._retired.remove(snapshot)
          break
      else:
        snapshot = None
    if snapshot is None:
      return self._new_snapshot(kind)
    if snapshot.last_use is not None:
      snapshot.last_use.synchronize()
    return snapshot

  @torch.no_grad()
  def _copy_into(self, snapshot, params):
    """Copy (or quantize) `params` into `snapshot` on the caller's
    current stream and mark the copy's end with an event."""
    mismatch = set(snapshot.params) ^ set(params)
    if mismatch:
      raise KeyError(f'params do not match the agent: {sorted(mismatch)}')
    for name, target in snapshot.params.items():
      if snapshot.kind == 'int8':
        codec_lib.quantize_leaf_(params[name].to(torch.float32), target)
      else:
        target.copy_(params[name])
    if self._cuda:
      snapshot.ready = torch.cuda.Event()
      snapshot.ready.record(torch.cuda.current_stream(self._device))
    return snapshot

  def _newest_nonlive_locked(self):
    for key in reversed(self._versions):
      if key != self._live_key:
        return self._versions[key]
    return None

  def _entry_for_locked(self, key):
    if key is None:
      return self._newest_nonlive_locked()
    return self._versions.get(key)

  def _pick_live_locked(self):
    """One call's serving entry under _lock: the live entry, or
    (serving_ab_fraction of calls, by a deterministic accumulator) the A/B
    candidate; its serve count and LRU tick are bumped."""
    self._serve_tick += 1
    entry = self._versions[self._live_key]
    if self._ab_fraction > 0.0:
      candidate = self._entry_for_locked(self._ab_key)
      if candidate is not None and candidate.key != self._live_key:
        self._ab_acc += self._ab_fraction
        if self._ab_acc >= 1.0:
          self._ab_acc -= 1.0
          entry = candidate
          self._ab_calls += 1
          _AB_CALLS.inc()
    entry.serves += 1
    entry.tick = self._serve_tick
    return entry

  def _pick_locked(self):
    """This merged call's snapshots under _lock: the `_pick_live_locked`
    entry's, and the shadow version's at serving_shadow_fraction, else
    None. Each is held (inflight)."""
    entry = self._pick_live_locked()
    shadow = None
    if self._shadow_fraction > 0.0:
      other = self._entry_for_locked(self._shadow_key)
      if other is not None and other.key != self._live_key:
        self._shadow_acc += self._shadow_fraction
        if self._shadow_acc >= 1.0:
          self._shadow_acc -= 1.0
          shadow = other.snapshot
    held = [entry.snapshot] + ([shadow] if shadow is not None else [])
    for snapshot in held:
      snapshot.inflight += 1
    return entry.snapshot, shadow

  def _release(self, snapshots, event):
    with self._lock:
      for snapshot in snapshots:
        if event is not None:
          snapshot.last_use = event
        snapshot.inflight -= 1

  def _install_locked(self, key, snapshot):
    self._serve_tick += 1
    self._versions[key] = _VersionEntry(key, snapshot, self._serve_tick)
    self._versions.move_to_end(key)
    self._live_key = key
    self._evict_locked()
    _RESIDENT_VERSIONS.set(float(len(self._versions)))

  def _evict_locked(self):
    """LRU-evict unpinned, non-live entries past the count cap and the
    byte budget; an evicted entry's snapshot retires to the pool."""
    while True:
      over_count = len(self._versions) > self._resident_cap
      over_bytes = (self._budget_bytes > 0 and len(self._versions) > 1 and
                    sum(e.snapshot.nbytes for e in self._versions.values())
                    > self._budget_bytes)
      if not (over_count or over_bytes):
        return
      victim = None
      for e in self._versions.values():
        if e.key == self._live_key or e.pinned:
          continue
        if victim is None or e.tick < victim.tick:
          victim = e
      if victim is None:
        log.warning('serving version table over budget (%d resident) but '
                    'every entry is live or pinned: nothing evictable',
                    len(self._versions))
        return
      del self._versions[victim.key]
      self._retired.append(victim.snapshot)
      self._evictions += 1
      _EVICTIONS.inc()
      log.info('serving: evicted resident version %s (LRU; %d left)',
               victim.label(), len(self._versions))

  def _flip_locked(self, key):
    self._serve_tick += 1
    entry = self._versions[key]
    entry.tick = self._serve_tick
    self._versions.move_to_end(key)
    self._live_key = key
    self._version_flips += 1
    self._params_version += 1
    _VERSION_FLIPS.inc()

  def update_params(self, params, version=None):
    """Publish `params` (the learner's tensors, by name) as the live
    version `version` (stats()['live_version']).

    - `version` is the live entry's: skipped (publishes_skipped).
    - `version` is resident but not live: live flips to it, no copy
      (version_flips).
    - otherwise: a copy (quantized under publish_codec='int8'), warmed
      per warmed bucket first when serving_aot meets a new structure,
      installed as live; LRU eviction follows.
    - None: always a fresh anonymous entry.

    The table is process memory: a server built after a restore copies
    on the first publish of any version."""
    if version is not None:
      with self._lock:
        if version == self._live_key:
          self._publishes_skipped += 1
          return
        if version in self._versions:
          self._flip_locked(version)
          return
    snapshot = self._copy_into(
        self._reusable_snapshot('int8' if self._quantize else 'f32'),
        params)
    if self._serving_aot:
      self._warm_structure(snapshot)
    with self._lock:
      key = version
      if key is None:
        self._anon_seq += 1
        key = ('anon', self._anon_seq)
      self._install_locked(key, snapshot)
      self._params_version += 1

  def pin_version(self, version, pinned=True):
    """Pin (or unpin) a resident version against eviction; True if it
    was resident."""
    with self._lock:
      entry = self._versions.get(version)
      if entry is None:
        return False
      entry.pinned = bool(pinned)
      return True

  def set_live(self, version):
    """Flip serving to a resident version without a publish; KeyError if
    it is not resident."""
    with self._lock:
      if version not in self._versions:
        raise KeyError(f'version {version!r} is not resident')
      if version != self._live_key:
        self._flip_locked(version)

  def set_ab(self, version, fraction):
    """Serve `fraction` of merged calls with `version` (None: the newest
    non-live resident); 0 turns A/B off."""
    fraction = float(fraction)
    if not 0.0 <= fraction <= 1.0:
      raise ValueError(f'ab fraction {fraction} outside [0, 1]')
    with self._lock:
      self._ab_key, self._ab_fraction, self._ab_acc = version, fraction, 0.0

  def set_shadow(self, version, fraction):
    """Replay `fraction` of merged calls against `version` (None: the
    newest non-live resident) and score greedy agreement with live into
    shadow_divergence; 0 turns shadow traffic off."""
    fraction = float(fraction)
    if not 0.0 <= fraction <= 1.0:
      raise ValueError(f'shadow fraction {fraction} outside [0, 1]')
    with self._lock:
      self._shadow_key = version
      self._shadow_fraction = fraction
      self._shadow_acc = 0.0

  def resident_versions(self):
    """[(label, serves, pinned, live)] per resident entry, in publish
    order."""
    with self._lock:
      return [(e.label(), e.serves, e.pinned, e.key == self._live_key)
              for e in self._versions.values()]

  def live_params(self):
    """The live version's parameter tensors, by name (read-only use;
    an int8 version's dequantized)."""
    with self._lock:
      snapshot = self._versions[self._live_key].snapshot
    return dict(codec_lib.dequantize_tree(snapshot.params))

  # -- serving --

  def policy(self, prev_action, env_output, core_state):
    """The Actor-contract policy: scalars in, scalars out. On the carry
    path the carry rides the wire both ways; in state-cache mode
    `core_state` is the slot handle from `initial_core_state`, only its
    slot id rides, and the handle is returned as the new state."""
    frame, instr = env_output.observation
    common = [np.asarray([prev_action], np.int32),
              np.asarray([env_output.reward], np.float32),
              np.asarray([env_output.done], bool),
              np.asarray(frame)[None],
              np.asarray(instr)[None]]
    if self._state_cache:
      if not isinstance(core_state, _SlotHandle):
        raise TypeError('state-cache mode: core_state must be the slot '
                        'handle from initial_core_state(), got '
                        f'{type(core_state).__name__}')
      if core_state.released:
        raise RuntimeError('policy() called with a released state slot')
      action, logits, baseline = self._batcher.compute(
          [np.asarray([core_state.slot], np.int32)] + common)
      new_state = core_state
    else:
      core_c, core_h = core_state
      action, logits, baseline, new_c, new_h = self._batcher.compute(
          common + [np.asarray(core_c, np.float32),
                    np.asarray(core_h, np.float32)])
      new_state = (new_c, new_h)
    return (AgentOutput(action=action[0], policy_logits=logits[0],
                        baseline=baseline[0]), new_state)

  @torch.no_grad()
  def serve_remote(self, payload):
    """Serve one carry-passing batch of routed inference (the remote
    ingest's 'infer' requests; driver.train attaches this).

    `payload` holds batch-leading arrays: prev_action [B] int32, reward
    [B] float32, done [B] bool, frame [B, H, W, C] uint8, instr [B, L]
    int32, core_c and core_h [B, hidden] float32. Returns numpy action,
    logits, baseline, core_c and core_h, and the serving version's label
    under 'version'. No arena slot is taken or written, and the actions
    are drawn from the routed generator, advanced per call."""
    t0 = time.perf_counter()
    inputs = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(payload[k], dtype)))
              for k, dtype in zip(_CARRY_INPUTS, _REMOTE_DTYPES)]
    with self._lock:
      entry = self._pick_live_locked()
      snapshot, label = entry.snapshot, entry.label()
      snapshot.inflight += 1
    try:
      with self._remote_lock:
        if self._cuda:
          with torch.cuda.device(self._device), torch.cuda.stream(
              self._stream):
            self._stream.wait_event(snapshot.ready)
            inputs = [t.to(self._device) for t in inputs]
            results = self._apply(snapshot, inputs[:5], tuple(inputs[5:]),
                                  self._remote_generator)
            # A blocking copy: the stream's work (this forward's reads of
            # the snapshot included) is complete when it returns.
            results = [r.cpu() for r in results]
        else:
          results = self._apply(snapshot, inputs[:5], tuple(inputs[5:]),
                                self._remote_generator)
    finally:
      self._release((snapshot,), None)
    action, logits, baseline, new_c, new_h = (r.numpy() for r in results)
    _SERVE_LATENCY.observe((time.perf_counter() - t0) * 1e3)
    return {'action': action, 'logits': logits, 'baseline': baseline,
            'core_c': new_c, 'core_h': new_h, 'version': label}

  def _padded_size(self, n):
    """Bucket of a merged batch of n: the next power of two of n (at
    least pad_batch_to), capped at inference_max_batch."""
    if self._pad_floor is not None:
      n = max(n, self._pad_floor)
    return min(_next_power_of_two(n), self._max_batch)

  def _in_meta(self, obs_spec):
    h, w, c = obs_spec['frame']
    meta = [(np.dtype(np.int32), ()), (np.dtype(np.float32), ()),
            (np.dtype(bool), ()), (np.dtype(np.uint8), (h, w, c)),
            (np.dtype(np.int32), (obs_spec['instr_len'],))]
    if self._state_cache:
      return [(np.dtype(np.int32), ())] + meta
    return meta + [(np.dtype(np.float32), (self._hidden,))] * 2

  def _out_meta(self):
    meta = [((), torch.int32), ((self._num_actions,), torch.float32),
            ((), torch.float32)]
    if not self._state_cache:
      meta += [((self._hidden,), torch.float32)] * 2
    return meta

  def _staging_for(self, total_rows, in_meta=None):
    """The next ring slot of the bucket for total_rows: with at most
    `depth` batches dispatched and not completed, and completions in FIFO
    order, a ring of depth + 1 reuses a slot only after its batch
    completed."""
    padded = self._padded_size(total_rows)
    ring = self._staging.get(padded)
    if ring is None:
      meta = in_meta or self._batcher.input_meta()
      ring = [_Staging(padded, meta, self._out_meta(), self._num_actions,
                       self._cuda) for _ in range(self._depth + 1)]
      self._staging[padded] = ring
      self._staging_calls[padded] = 0
    slot = ring[self._staging_calls[padded] % len(ring)]
    self._staging_calls[padded] += 1
    return slot

  def _apply(self, snapshot, inputs, core, generator):
    """The T=1 agent step on `snapshot`'s parameters: (action int32,
    logits, baseline, new c, new h) over the padded rows."""
    prev_action, reward, done, frame, instr = inputs
    env_output = StepOutput(reward=reward[None], info=None, done=done[None],
                            observation=(frame[None], instr[None]))
    args = (prev_action[None], env_output, core)
    if snapshot.kind == 'int8':
      # functional_call swaps the template's parameters for the call:
      # one caller at a time (a publish's warm forward runs beside the
      # dispatch thread).
      with self._template_lock:
        out, (new_c, new_h) = torch.func.functional_call(
            self._template, codec_lib.dequantize_tree(snapshot.params),
            args, {'sample_generator': generator})
    else:
      out, (new_c, new_h) = snapshot.agent(*args,
                                           sample_generator=generator)
    return (out.action[0].to(torch.int32), out.policy_logits[0],
            out.baseline[0], new_c, new_h)

  @torch.no_grad()
  def _run(self, snapshot, staging, shadow=None, generator=None):
    """One padded batch: inputs from the pinned staging buffers, outputs
    (and the shadow's logits) into its pinned output buffers. Returns the
    event the outputs are complete at (None on the CPU)."""
    generator = self._generator if generator is None else generator
    if not self._cuda:
      return self._forward(snapshot, staging.in_tensors, staging, shadow,
                           generator)
    with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
      for held in (snapshot, shadow):
        if held is not None:
          self._stream.wait_event(held.ready)
      inputs = [t.to(self._device, non_blocking=True)
                for t in staging.in_tensors]
      return self._forward(snapshot, inputs, staging, shadow, generator)

  def _forward(self, snapshot, inputs, staging, shadow, generator):
    if self._state_cache:
      # The gather, the step and the scatter in one hold of the arena
      # lock: a grow in between would copy the carries before the step's.
      with self._arena_lock:
        slot_ids, inputs = inputs[0], inputs[1:]
        rows = slot_ids.long()
        # Padded rows (and any id past the arena) take the extra row.
        rows = torch.where(rows < self._num_slots, rows, self._num_slots)
        core = tuple(a.index_select(0, rows) for a in self._arena)
        results = self._step(snapshot, inputs, core, staging, shadow,
                             generator)
        for a, new in zip(self._arena, results[3:]):
          a.index_copy_(0, rows, new)
    else:
      inputs, core = inputs[:5], tuple(inputs[5:])
      self._step(snapshot, inputs, core, staging, shadow, generator)
    if not self._cuda:
      return None
    event = torch.cuda.Event()
    event.record(self._stream)
    return event

  def _step(self, snapshot, inputs, core, staging, shadow, generator):
    """The shadow's and the live version's forwards on the gathered
    carries, their outputs copied to the staging buffers; returns the
    live results."""
    outputs = []
    if shadow is not None:
      # Before the live step: both read the same carries.
      outputs.append(self._apply(shadow, inputs, core, None)[1])
    state = generator.get_state()
    try:
      results = self._apply(snapshot, inputs, core, generator)
      # The cache path's staging has no carry outputs: zip stops at
      # (action, logits, baseline).
      self._copy_out(staging, results, outputs)
    except BaseException:
      self._recover_chain(generator, state)
      raise
    return results

  def _copy_out(self, staging, results, shadow_out):
    for pinned, result in zip(staging.out_tensors, results):
      pinned.copy_(result, non_blocking=self._cuda)
    if shadow_out:
      staging.shadow_logits.copy_(shadow_out[0], non_blocking=self._cuda)

  def _recover_chain(self, generator, state):
    """A forward raised: put the sampling generator back where the call
    found it (the arena's scatter comes after every step that can raise,
    so the arena is untouched), so a retried call draws what it would
    have drawn."""
    generator.set_state(state)
    with self._lock:
      self._chain_recoveries += 1

  def _note_serve(self, snapshot, padded):
    """Count a serve of a (bucket, structure) pair no warm forward
    covered (serving_aot)."""
    if not self._serving_aot:
      return
    with self._lock:
      missed = (padded, snapshot.kind) not in self._warmed
      if missed:
        self._aot_misses += 1
    if missed:
      _AOT_MISSES.inc()

  def _dispatch_loop(self):
    picked = []

    def staging_inputs(rows):
      picked.append(self._staging_for(rows))
      return picked[-1].inputs

    while True:
      picked.clear()
      try:
        item = self._batcher.get_batch_into(staging_inputs)
      except Exception:
        log.exception('inference dispatch: merged-batch staging failed')
        continue
      if item is None:
        self._completion_q.put(None)
        return
      batch_id, n, _ = item
      staging = picked[-1]
      t0 = time.perf_counter()
      held = ()
      try:
        if self._state_cache:
          # The ring reuses buffers: rows past n may hold an earlier
          # merge's slot ids.
          staging.inputs[0][n:] = _PAD_SLOT_ID
        with self._lock:
          self._calls += 1
          self._merged_requests += n
          self._h2d_bytes += staging.nbytes_in
          self._d2h_bytes += staging.nbytes_out
          snapshot, shadow = self._pick_locked()
        held = (snapshot,) + ((shadow,) if shadow is not None else ())
        self._note_serve(snapshot, len(staging.inputs[0]))
        self._sem.acquire()
        try:
          event = self._run(snapshot, staging, shadow)
          with self._lock:
            self._inflight += 1
            self._inflight_peak = max(self._inflight_peak, self._inflight)
        except BaseException:
          self._release(held, None)
          self._sem.release()
          raise
        self._completion_q.put((batch_id, n, t0, staging, held, event,
                                shadow is not None))
      except Exception as e:  # answer the parked callers
        self._batcher.set_error(batch_id, f'{type(e).__name__}: {e}')

  def _completion_loop(self):
    while True:
      item = self._completion_q.get()
      if item is None:
        return
      batch_id, n, t0, staging, held, event, shadowed = item
      try:
        if event is not None:
          event.synchronize()
        self._batcher.set_outputs(
            batch_id, [t.numpy()[:n] for t in staging.out_tensors])
        if shadowed:
          # After the callers are answered; before the ring slot is
          # released. Greedy agreement: sampled actions differ by the
          # generator alone.
          divergence = 1.0 - codec_lib.greedy_agreement(
              staging.out_tensors[1].numpy()[:n],
              staging.shadow_logits.numpy()[:n])
          with self._lock:
            self._shadow_calls += 1
            self._shadow_divergence = (
                divergence if self._shadow_calls == 1 else
                0.9 * self._shadow_divergence + 0.1 * divergence)
            ewma = self._shadow_divergence
          _SHADOW_CALLS.inc()
          _SHADOW_DIVERGENCE.set(ewma)
      except Exception as e:
        try:
          self._batcher.set_error(batch_id, f'{type(e).__name__}: {e}')
        except Exception:
          pass
      finally:
        self._release(held, event)
        self._sem.release()
      lat_ms = (time.perf_counter() - t0) * 1e3
      _SERVE_LATENCY.observe(lat_ms)
      with self._lock:
        self._inflight -= 1
        self._latencies.append(lat_ms)

  def _warm_bucket(self, padded, snapshot, generator=None):
    """One forward of zero inputs in bucket `padded` on `snapshot`
    (padded slot ids: no live slot is touched), waited for."""
    out_meta = self._out_meta()
    with self._lock:
      warm_meta = self._warm_meta
    staging = _Staging(padded, self._in_meta(warm_meta), out_meta,
                       self._num_actions, self._cuda)
    if self._state_cache:
      staging.inputs[0][:] = _PAD_SLOT_ID
    with self._lock:
      snapshot.inflight += 1
    event = None
    try:
      event = self._run(snapshot, staging, generator=generator)
      if event is not None:
        event.synchronize()
    finally:
      self._release((snapshot,), event)
    with self._lock:
      self._warmed.add((padded, snapshot.kind))

  def _warm_structure(self, snapshot):
    """serving_aot at publish: a warm forward per warmed bucket not yet
    run under `snapshot`'s structure, on a scratch generator (the live
    one is the dispatch thread's)."""
    with self._lock:
      cold = [padded for padded in sorted(self._warm_buckets)
              if (padded, snapshot.kind) not in self._warmed]
    for padded in cold:
      self._warm_bucket(padded, snapshot,
                        torch.Generator(self._device).manual_seed(0))

  def warmup(self, obs_spec, sizes=None, max_size=None):
    """Run each padded bucket once before the fleet starts (the first
    call of a shape sets up its convolution algorithms and buffers):
    those of the unpadded `sizes`, else every bucket up to `max_size`
    (None: inference_max_batch). `obs_spec` is {'frame': (H, W, C),
    'instr_len': L}."""
    with self._lock:
      self._warm_meta = obs_spec
    if sizes is None:
      cap = self._max_batch if max_size is None else min(
          _next_power_of_two(max_size), self._max_batch)
      sizes, s = [], 1
      while s <= cap:
        sizes.append(s)
        s *= 2
    with self._lock:
      snapshot = self._versions[self._live_key].snapshot
    for padded in sorted({self._padded_size(s) for s in sizes}):
      with self._lock:
        self._warm_buckets.add(padded)
      self._warm_bucket(padded, snapshot)

  def stats(self):
    """Merge, service, admission and version-table counters.
    params_version counts the publishes and flips; mean_batch near 1
    means the batcher is not merging; the latency percentiles are per
    merged call, over the last 512 calls, from assembly to the callers'
    release; h2d_bytes and d2h_bytes count the staged inputs and outputs
    of every merged call (padded rows included) and the arena's slot
    reads and writes; resident_bytes sums the resident versions'
    parameter bytes."""
    with self._lock:
      calls, reqs = self._calls, self._merged_requests
      lat = sorted(self._latencies)
      live = self._versions[self._live_key]
      out = {
          'calls': calls,
          'requests': reqs,
          'mean_batch': (reqs / calls) if calls else 0.0,
          'params_version': self._params_version,
          'publishes_skipped': self._publishes_skipped,
          'live_version': live.label(),
          'latency_p50_ms': round(percentile_ms(lat, 0.5), 3),
          'latency_p99_ms': round(percentile_ms(lat, 0.99), 3),
          'pipeline_depth': self._depth,
          'inflight_peak': self._inflight_peak,
          'chain_recoveries': self._chain_recoveries,
          'snapshots': len(self._snapshots),
          'h2d_bytes': self._h2d_bytes,
          'd2h_bytes': self._d2h_bytes,
          'state_cache': self._state_cache,
          'acquires': self._acquires,
          'admission_waits': self._admission_waits,
          'admission_wait_p99_ms': (
              self._admission_wait_reservoir.percentile_ms(0.99)[0]),
          'sheds': self._sheds,
          'admission_timeouts': self._admission_timeouts,
          'arena_grows': self._arena_grows,
          'unjoined_threads': self._unjoined_threads,
          'resident_versions': len(self._versions),
          'resident_bytes': sum(e.snapshot.nbytes
                                for e in self._versions.values()),
          'serve_counts': {str(e.label()): e.serves
                           for e in self._versions.values()},
          'version_flips': self._version_flips,
          'evictions': self._evictions,
          'ab_calls': self._ab_calls,
          'shadow_calls': self._shadow_calls,
          'shadow_divergence': round(self._shadow_divergence, 6),
          'aot_misses': self._aot_misses,
          'aot_compiled': len(self._warmed) if self._serving_aot else 0,
      }
    with self._slot_lock:
      out.update(admission=self._admission,
                 waitlist_depth=len(self._waiters),
                 num_slots=self._num_slots,
                 slots_free=len(self._free) if self._state_cache else None)
    return out

  def close(self):
    """Answer the parked admission waiters with InferenceClosed, cancel
    the parked callers, let in-flight batches complete, and join the
    threads (a thread that misses its deadline is logged and counted)."""
    with self._slot_lock:
      if self._closed:
        return
      self._closed = True
      waiters, self._waiters = self._waiters, []
      for waiter in waiters:
        waiter.closed = True
        waiter.event.set()
    self._batcher.close()
    unjoined = []
    for thread in (self._dispatch_thread, self._completion_thread):
      thread.join(timeout=10)
      if thread.is_alive():
        unjoined.append(thread.name)
    if unjoined:
      with self._lock:
        self._unjoined_threads = len(unjoined)
      log.warning('InferenceServer.close(): %d thread(s) missed the join '
                  'deadline: %s', len(unjoined), ', '.join(unjoined))
    if self._cuda:
      self._stream.synchronize()
