"""Batched inference server: many actor threads, one batched agent call on
the device, ported from the JAX package's runtime/inference.py (the
carry-passing path with one resident version).

- Actor threads call `policy(prev_action, env_output, core_state)` (the
  `runtime.actor.Actor` contract) and block.
- The C++ batcher (ops/dynamic_batching.py) merges concurrent calls; its
  merge copy lands in pinned staging buffers, padded to a power-of-two
  bucket (`_padded_size`).
- A dispatch thread copies the merged batch to the device on the
  server's own stream, runs the single-step agent, and copies the outputs
  back into pinned buffers behind an event; a completion thread waits on
  the event and unparks the callers. At most `inference_pipeline_depth`
  batches are dispatched and not completed, so batch k+1 assembles and
  lands while batch k computes. On the CPU every step is synchronous.
- Actions are sampled from one `torch.Generator` on the device, used by
  the dispatch thread only.

Weights. The server owns its parameters: each published version is a
*snapshot*, a copy of the agent on the device, taken by `update_params`
on the publisher's current stream (the learner's), so the copy is
ordered after the step that produced the params and before the
learner's next in-place update, and an event marks it complete. The
dispatch stream waits on that event before it reads a snapshot, so no
call sees a half-written copy. A retired snapshot is reused for a later
publish only once no dispatch holds it and the last dispatch that read
it has completed on the device; until then a new one is made (the pool
grows to what the pipeline needs). As in the reference, the actions of
one unroll may span weight versions.

Unported (ROADMAP A7): the device-resident state cache, the serving
version table (A/B, shadow, AOT), the int8 publish codec and the
shed/grow admission modes; `config.validate_fleet` raises for each.
"""

import collections
import copy
import logging
import queue
import threading
import time

import numpy as np
import torch

from scalable_agent_tpu_torch.config import validate_fleet
from scalable_agent_tpu_torch.ops import dynamic_batching
from scalable_agent_tpu_torch.structs import AgentOutput, StepOutput

log = logging.getLogger('scalable_agent_tpu_torch')

# Inputs of one merged call, in the batcher's tensor order.
_INPUTS = ('prev_action', 'reward', 'done', 'frame', 'instr', 'core_c',
           'core_h')


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


class _Snapshot:
  """One published version: an agent copy on the device, the event its
  copy completes at, the dispatches holding it, and the event of the
  last dispatch that read it."""

  def __init__(self, agent):
    self.agent = agent
    self.params = dict(agent.named_parameters())
    self.version = None
    self.ready = None      # torch.cuda.Event (None on the CPU)
    self.inflight = 0
    self.last_use = None   # torch.cuda.Event (None on the CPU)


class _Staging:
  """Pinned host buffers of one ring slot of a padded bucket: the merged
  inputs (the batcher copies into `inputs`) and the outputs (the device
  copies back into `outputs`)."""

  def __init__(self, padded, in_meta, num_actions, hidden, pin):
    # Zeroed: the rows past a batch's size are computed too, and must
    # hold valid inputs (an action id in range) from the start.
    def zeros(shape, dtype):
      return torch.zeros(shape, dtype=dtype, pin_memory=pin)
    self.in_tensors = [
        zeros((padded,) + tuple(trail),
              torch.from_numpy(np.empty(0, dtype)).dtype)
        for dtype, trail in in_meta]
    self.inputs = [t.numpy() for t in self.in_tensors]
    self.out_tensors = [zeros((padded,), torch.int32),
                        zeros((padded, num_actions), torch.float32),
                        zeros((padded,), torch.float32),
                        zeros((padded, hidden), torch.float32),
                        zeros((padded, hidden), torch.float32)]


class InferenceServer:
  """Serves a batched policy to host actor threads.

  Args:
    agent: an ImpalaAgent; the server keeps copies of it on `device` (its
      own parameter tensors), never the learner's module.
    params: the initial parameters by name (the learner's
      `TrainState.params`); copied.
    config: Config (the inference_* fields; validate_fleet's checks).
    seed: seed of the action-sampling generator.
    fleet_size: the number of actor threads served: the merge floor when
      config.inference_min_batch == 0 (AUTO).
    device: where inference runs (default: the params' device).
  """

  def __init__(self, agent, params, config, seed=0, fleet_size=None,
               device=None):
    validate_fleet(config)
    self._device = torch.device(
        device if device is not None else next(iter(params.values())).device)
    self._cuda = self._device.type == 'cuda'
    min_batch = config.inference_min_batch
    if min_batch == 0:
      min_batch = max(fleet_size or 1, 1)
    self._min_batch = min(min_batch, config.inference_max_batch)
    self._max_batch = config.inference_max_batch
    self._depth = max(1, int(config.inference_pipeline_depth))
    self._num_actions = agent.num_actions
    self._hidden = agent.hidden_size
    self._template = copy.deepcopy(agent).to(self._device).eval()
    self._template.requires_grad_(False)

    self._stream = torch.cuda.Stream(self._device) if self._cuda else None
    self._generator = torch.Generator(self._device).manual_seed(seed)
    self._lock = threading.Lock()  # snapshots, versions and stats
    self._snapshots = []           # every snapshot made (for close)
    self._retired = collections.deque()
    self._live = None
    self._params_version = 0
    self._calls = 0
    self._merged_requests = 0
    self._inflight = 0
    self._inflight_peak = 0
    self._latencies = collections.deque(maxlen=512)
    self._unjoined_threads = 0
    self._closed = False
    self._install(self._copy_into(self._new_snapshot(), params), None)

    self._staging = {}        # padded size -> ring of _Staging
    self._staging_calls = {}  # padded size -> calls (ring index)
    self._batcher = dynamic_batching.Batcher(
        num_tensors=len(_INPUTS), minimum_batch_size=self._min_batch,
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

  # -- weights --

  def _new_snapshot(self):
    snapshot = _Snapshot(copy.deepcopy(self._template))
    self._snapshots.append(snapshot)
    return snapshot

  def _reusable_snapshot(self):
    """A retired snapshot no dispatch holds, its last read complete on
    the device; a new one when every retired snapshot is still held."""
    with self._lock:
      for snapshot in self._retired:
        if snapshot.inflight == 0:
          self._retired.remove(snapshot)
          break
      else:
        snapshot = None
    if snapshot is None:
      return self._new_snapshot()
    if snapshot.last_use is not None:
      snapshot.last_use.synchronize()
    return snapshot

  @torch.no_grad()
  def _copy_into(self, snapshot, params):
    """Copy `params` into `snapshot` on the caller's current stream and
    mark the copy's end with an event."""
    mismatch = set(snapshot.params) ^ set(params)
    if mismatch:
      raise KeyError(f'params do not match the agent: {sorted(mismatch)}')
    for name, tensor in snapshot.params.items():
      tensor.copy_(params[name])
    if self._cuda:
      snapshot.ready = torch.cuda.Event()
      snapshot.ready.record(torch.cuda.current_stream(self._device))
    return snapshot

  def _install(self, snapshot, version):
    with self._lock:
      if self._live is not None:
        self._retired.append(self._live)
      snapshot.version = version
      self._live = snapshot

  def update_params(self, params, version):
    """Publish a copy of `params` (the learner's tensors, by name) as the
    live snapshot, labelled `version` (stats()['live_version'])."""
    self._install(self._copy_into(self._reusable_snapshot(), params),
                  version)
    with self._lock:
      self._params_version += 1

  def live_params(self):
    """The live snapshot's parameter tensors, by name (read-only use)."""
    with self._lock:
      return dict(self._live.params)

  # -- serving --

  def initial_core_state(self):
    """A zeroed host carry (c, h), [1, hidden] each, for one actor."""
    return tuple(np.zeros((1, self._hidden), np.float32) for _ in range(2))

  def policy(self, prev_action, env_output, core_state):
    """The Actor-contract policy: scalars in, scalars out; the carry
    rides the wire both ways."""
    frame, instr = env_output.observation
    core_c, core_h = core_state
    action, logits, baseline, new_c, new_h = self._batcher.compute([
        np.asarray([prev_action], np.int32),
        np.asarray([env_output.reward], np.float32),
        np.asarray([env_output.done], bool),
        np.asarray(frame)[None],
        np.asarray(instr)[None],
        np.asarray(core_c, np.float32),
        np.asarray(core_h, np.float32)])
    return (AgentOutput(action=action[0], policy_logits=logits[0],
                        baseline=baseline[0]),
            (new_c, new_h))

  def _padded_size(self, n):
    """Bucket of a merged batch of n: the next power of two, capped at
    inference_max_batch."""
    return min(_next_power_of_two(n), self._max_batch)

  def _staging_for(self, total_rows, in_meta=None):
    """The next ring slot of the bucket for total_rows: with at most
    `depth` batches dispatched and not completed, and completions in FIFO
    order, a ring of depth + 1 reuses a slot only after its batch
    completed."""
    padded = self._padded_size(total_rows)
    ring = self._staging.get(padded)
    if ring is None:
      meta = in_meta or self._batcher.input_meta()
      ring = [_Staging(padded, meta, self._num_actions, self._hidden,
                       self._cuda) for _ in range(self._depth + 1)]
      self._staging[padded] = ring
      self._staging_calls[padded] = 0
    slot = ring[self._staging_calls[padded] % len(ring)]
    self._staging_calls[padded] += 1
    return slot

  def _acquire_live(self):
    with self._lock:
      snapshot = self._live
      snapshot.inflight += 1
    return snapshot

  def _release(self, snapshot, event):
    with self._lock:
      if event is not None:
        snapshot.last_use = event
      snapshot.inflight -= 1

  @torch.no_grad()
  def _run(self, snapshot, staging):
    """One padded batch through the snapshot's agent: inputs from the
    pinned staging buffers, outputs into its pinned output buffers.
    Returns the event the outputs are complete at (None on the CPU)."""
    if not self._cuda:
      return self._forward(snapshot, staging.in_tensors, staging)
    with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
      self._stream.wait_event(snapshot.ready)
      inputs = [t.to(self._device, non_blocking=True)
                for t in staging.in_tensors]
      return self._forward(snapshot, inputs, staging)

  def _forward(self, snapshot, inputs, staging):
    prev_action, reward, done, frame, instr, core_c, core_h = inputs
    env_output = StepOutput(reward=reward[None], info=None, done=done[None],
                            observation=(frame[None], instr[None]))
    out, (new_c, new_h) = snapshot.agent(
        prev_action[None], env_output, (core_c, core_h),
        sample_generator=self._generator)
    results = (out.action[0].to(torch.int32), out.policy_logits[0],
               out.baseline[0], new_c, new_h)
    for pinned, result in zip(staging.out_tensors, results):
      pinned.copy_(result, non_blocking=self._cuda)
    if not self._cuda:
      return None
    event = torch.cuda.Event()
    event.record(self._stream)
    return event

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
      snapshot = None
      try:
        # Rows past n (the bucket's padding) hold zeros or an earlier
        # batch's inputs: computed, never answered.
        with self._lock:
          self._calls += 1
          self._merged_requests += n
        self._sem.acquire()
        try:
          snapshot = self._acquire_live()
          event = self._run(snapshot, staging)
          with self._lock:
            self._inflight += 1
            self._inflight_peak = max(self._inflight_peak, self._inflight)
        except BaseException:
          if snapshot is not None:
            self._release(snapshot, None)
          self._sem.release()
          raise
        self._completion_q.put((batch_id, n, t0, staging, snapshot, event))
      except Exception as e:  # answer the parked callers
        self._batcher.set_error(batch_id, f'{type(e).__name__}: {e}')

  def _completion_loop(self):
    while True:
      item = self._completion_q.get()
      if item is None:
        return
      batch_id, n, t0, staging, snapshot, event = item
      try:
        if event is not None:
          event.synchronize()
        self._batcher.set_outputs(
            batch_id, [t.numpy()[:n] for t in staging.out_tensors])
      except Exception as e:
        try:
          self._batcher.set_error(batch_id, f'{type(e).__name__}: {e}')
        except Exception:
          pass
      finally:
        self._release(snapshot, event)
        self._sem.release()
      with self._lock:
        self._inflight -= 1
        self._latencies.append((time.perf_counter() - t0) * 1e3)

  def warmup(self, obs_spec, max_size=None):
    """Run every padded bucket up to `max_size` (None:
    inference_max_batch) once before the fleet starts: the first call of
    a shape sets up its convolution algorithms and buffers.
    `obs_spec` is {'frame': (H, W, C), 'instr_len': L}."""
    h, w, c = obs_spec['frame']
    meta = [(np.dtype(np.int32), ()), (np.dtype(np.float32), ()),
            (np.dtype(bool), ()), (np.dtype(np.uint8), (h, w, c)),
            (np.dtype(np.int32), (obs_spec['instr_len'],)),
            (np.dtype(np.float32), (self._hidden,)),
            (np.dtype(np.float32), (self._hidden,))]
    cap = self._max_batch if max_size is None else min(
        _next_power_of_two(max_size), self._max_batch)
    sizes, s = [], 1
    while s <= cap:
      sizes.append(s)
      s *= 2
    for padded in sorted({self._padded_size(s) for s in sizes}):
      staging = self._staging_for(padded, meta)
      snapshot = self._acquire_live()
      event = self._run(snapshot, staging)
      if event is not None:
        event.synchronize()
      self._release(snapshot, event)

  def stats(self):
    """{'calls', 'requests', 'mean_batch', 'params_version',
    'live_version', 'latency_p50_ms', 'latency_p99_ms',
    'pipeline_depth', 'inflight_peak', 'snapshots', 'unjoined_threads'}.
    params_version counts the publishes; mean_batch near 1 means the
    batcher is not merging; the latency percentiles are per merged call,
    over the last 512 calls, from assembly to the callers' release."""
    with self._lock:
      calls, reqs = self._calls, self._merged_requests
      lat = sorted(self._latencies)
      return {
          'calls': calls,
          'requests': reqs,
          'mean_batch': (reqs / calls) if calls else 0.0,
          'params_version': self._params_version,
          'live_version': self._live.version,
          'latency_p50_ms': round(percentile_ms(lat, 0.5), 3),
          'latency_p99_ms': round(percentile_ms(lat, 0.99), 3),
          'pipeline_depth': self._depth,
          'inflight_peak': self._inflight_peak,
          'snapshots': len(self._snapshots),
          'unjoined_threads': self._unjoined_threads,
      }

  def close(self):
    """Cancel the parked callers, let in-flight batches complete, and
    join the threads (a thread that misses its deadline is logged and
    counted)."""
    with self._lock:
      if self._closed:
        return
      self._closed = True
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
