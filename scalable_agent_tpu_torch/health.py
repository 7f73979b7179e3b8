"""Training health: the host half of the JAX package's health.py — the
sentinel read, the detectors, the escalation ladder and the halt bundle.

The learner's step already skips a non-finite update on the device
(learner.make_train_step_fn with config.health_watchdog: params and
optimizer state keep their old values, and `metrics['step_ok']` says
so). The `HealthMonitor` reads each step's sentinels one step late and
escalates bad steps:

  skip and count  ->  ROLLBACK after K consecutive bad steps
                  ->  HALT after max_rollbacks rollbacks

The loops (driver.train, driver.train_anakin) act on the verdicts: a
rollback restores the last-known-good checkpoint
(checkpoint.Checkpointer.restore_last_good) and keeps the step counter
monotone; a halt writes a diagnostic bundle and raises
`TrainingDivergence` instead of training through divergence.

The sentinel read: `stack_sentinels` stacks the step's 0-d metrics into
one tensor and, on CUDA, copies it without blocking into pinned memory
behind an event; `read_handle` waits on that event alone. Read one step
later, the values are computed by then, so the learner's stream never
waits for the host.

The SDC detector reads `sdc_replica_mismatch`, which the fleet's loop
adds under data parallelism from the replicas' param fingerprints
(parallel/train_parallel.make_sdc_fingerprint_fn), read one step late
like the other sentinels (`read_fingerprints`). The PopArt detectors are
here as in JAX, and stay off until PopArt exists (ROADMAP A2). The
flight recorder of the halt bundle waits for the telemetry plane
(A7.4).
"""

import collections
import dataclasses
import json
import os
import platform
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Verdicts (strings: they go straight into logs and JSONL).
OK = 'ok'
BAD = 'bad'
ROLLBACK = 'rollback'
HALT = 'halt'

# Sentinel keys read from the step metrics, in wire order. Missing keys
# read as None and their detectors stay off.
_SENTINEL_KEYS = ('step_ok', 'total_loss', 'grad_norm',
                  'popart_sigma_min', 'popart_sigma_max')


class TrainingDivergence(RuntimeError):
  """Training health escalated past its rollback budget; the run halted
  with a diagnostic bundle. `.bundle_path` names the bundle."""

  def __init__(self, message: str, bundle_path: Optional[str] = None):
    super().__init__(message)
    self.bundle_path = bundle_path


class SentinelHandle(NamedTuple):
  """A step's stacked sentinels on their way to the host: `values` is a
  host tensor (pinned on CUDA) that `ready` (a CUDA event, None on the
  CPU) says is filled."""
  keys: tuple
  values: torch.Tensor
  ready: Optional[torch.cuda.Event]


def stack_sentinels(metrics: Dict) -> SentinelHandle:
  """Stack the step's health scalars into one tensor and start its copy
  to the host; keys the config does not produce are absent."""
  present = tuple(k for k in _SENTINEL_KEYS if k in metrics)
  stacked = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                         for k in present])
  if not stacked.is_cuda:
    return SentinelHandle(present, stacked, None)
  host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
  host.copy_(stacked, non_blocking=True)
  ready = torch.cuda.Event()
  ready.record()
  return SentinelHandle(present, host, ready)


def read_handle(handle: SentinelHandle) -> Dict[str, Optional[float]]:
  """The handle's values on the host; missing keys come back None,
  distinct from NaN, which means produced and non-finite."""
  if handle.ready is not None:
    handle.ready.synchronize()
  values = handle.values.numpy()
  out = {k: None for k in _SENTINEL_KEYS}
  out.update({k: float(v) for k, v in zip(handle.keys, values)})
  return out


def read_fingerprints(fingerprints) -> Tuple[float, List[int]]:
  """The SDC sentinel's reading of the replicas' all-gathered param
  fingerprints: (sdc_replica_mismatch, the fingerprints). 1.0 when any
  replica's differs from the first's: deterministic compute was
  violated."""
  values = [int(v) for v in fingerprints.tolist()]
  return (1.0 if any(v != values[0] for v in values) else 0.0), values


def read_sentinels(metrics: Dict) -> Dict[str, Optional[float]]:
  """Immediate (blocking) sentinel read."""
  return read_handle(stack_sentinels(metrics))


@dataclasses.dataclass
class _WindowEntry:
  step: int
  wall_time: float
  values: Dict[str, float]
  verdict: str
  reason: str


class HealthMonitor:
  """Sliding-window divergence detection and the escalation ladder.

  Args:
    window: retained recent checks (also the halt bundle's tail).
    min_window: good samples before the relative detectors (loss
      explosion, sigma divergence) arm.
    rollback_after: K consecutive bad steps before a ROLLBACK verdict.
    max_rollbacks: rollbacks granted before the ladder escalates to HALT.
    loss_explosion_factor: |loss| beyond this multiple of the window
      median |loss| (floored at 1) flags the step even when finite.
    sigma_divergence_factor: PopArt sigma_max beyond this multiple of its
      window median, or sigma_min below its median over it, flags the
      step.
  """

  def __init__(self, window: int = 64, min_window: int = 16,
               rollback_after: int = 5, max_rollbacks: int = 3,
               loss_explosion_factor: float = 100.0,
               sigma_divergence_factor: float = 10.0):
    if rollback_after < 1:
      raise ValueError('rollback_after must be >= 1')
    self._window = collections.deque(maxlen=max(window, 8))
    self._good_losses = collections.deque(maxlen=max(window, 8))
    self._good_sigmas = collections.deque(maxlen=max(window, 8))
    self._good_sigma_mins = collections.deque(maxlen=max(window, 8))
    self._min_window = min_window
    self._rollback_after = rollback_after
    self._max_rollbacks = max_rollbacks
    self._loss_factor = loss_explosion_factor
    self._sigma_factor = sigma_divergence_factor
    self._consecutive_bad = 0
    self.skipped_steps = 0    # skipped on the device (non-finite)
    self.flagged_steps = 0    # every bad verdict
    self.rollbacks = 0
    self.halts = 0
    self.sdc_mismatches = 0   # replica fingerprints disagreed
    self.last_reason = ''     # why the most recent bad step was bad
    # Incidents other planes report (counted per kind; not verdicts).
    self._external: Dict[str, int] = {}
    self._external_lock = threading.Lock()

  # --- detectors ---

  def _classify(self, values: Dict[str, Optional[float]]):
    """(is_bad, reason) for one step's sentinel values. None means not
    produced by this config (the detector stays off); NaN or inf means
    produced and non-finite (bad)."""
    sdc = values.get('sdc_replica_mismatch')
    if sdc is not None and sdc > 0.5:
      # First: a replica whose params silently diverged invalidates
      # every other sentinel of the step.
      return True, ('SDC: per-replica param fingerprints disagree — '
                    'deterministic compute violated (suspect chip/'
                    'HBM; see docs/RUNBOOK.md §9)')
    step_ok = values.get('step_ok')
    if step_ok is not None and step_ok < 0.5:
      return True, 'non-finite loss/grad (update skipped on device)'
    loss = values.get('total_loss')
    if loss is not None and not np.isfinite(loss):
      return True, f'non-finite total_loss ({loss})'
    grad = values.get('grad_norm')
    if grad is not None and not np.isfinite(grad):
      return True, f'non-finite grad_norm ({grad})'
    if loss is not None and len(self._good_losses) >= self._min_window:
      # The baseline is floored at 1: the detector targets divergence by
      # orders of magnitude, and a converged run's median |loss| nears 0.
      baseline = float(np.median(np.abs(self._good_losses)))
      if abs(loss) > self._loss_factor * max(baseline, 1.0):
        return True, (f'loss explosion: |{loss:.4g}| > '
                      f'{self._loss_factor:g} x window median '
                      f'{baseline:.4g}')
    sigma = values.get('popart_sigma_max')
    if (sigma is not None and np.isfinite(sigma)
        and len(self._good_sigmas) >= self._min_window):
      baseline = float(np.median(self._good_sigmas))
      if sigma > self._sigma_factor * max(baseline, 1e-6):
        return True, (f'PopArt sigma divergence: {sigma:.4g} > '
                      f'{self._sigma_factor:g} x window median '
                      f'{baseline:.4g}')
    sigma_min = values.get('popart_sigma_min')
    if (sigma_min is not None and np.isfinite(sigma_min)
        and len(self._good_sigma_mins) >= self._min_window):
      baseline = float(np.median(self._good_sigma_mins))
      if sigma_min * self._sigma_factor < baseline:
        return True, (f'PopArt sigma collapse: {sigma_min:.4g} < '
                      f'window median {baseline:.4g} / '
                      f'{self._sigma_factor:g}')
    return False, ''

  # --- the ladder ---

  def observe(self, step: int, metrics: Dict) -> str:
    """Feed one step's metrics (a blocking read); returns the verdict."""
    return self.observe_values(step, read_sentinels(metrics))

  def observe_values(self, step: int,
                     values: Dict[str, Optional[float]]) -> str:
    """`observe` on values already on the host. The caller acts on
    ROLLBACK and HALT; BAD means skipped and counted."""
    bad, reason = self._classify(values)
    verdict = OK
    if bad:
      self.last_reason = reason
      self.flagged_steps += 1
      if reason.startswith('SDC:'):
        self.sdc_mismatches += 1
      step_ok = values.get('step_ok')
      if step_ok is not None and step_ok < 0.5:
        self.skipped_steps += 1
      self._consecutive_bad += 1
      verdict = BAD
      if self._consecutive_bad >= self._rollback_after:
        self._consecutive_bad = 0
        # `rollbacks` counts rollbacks granted; the request past the
        # budget halts without counting as one.
        if self.rollbacks >= self._max_rollbacks:
          self.halts += 1
          verdict = HALT
        else:
          self.rollbacks += 1
          verdict = ROLLBACK
    else:
      self._consecutive_bad = 0
      loss = values.get('total_loss')
      if loss is not None and np.isfinite(loss):
        self._good_losses.append(loss)
      sigma = values.get('popart_sigma_max')
      if sigma is not None and np.isfinite(sigma):
        self._good_sigmas.append(sigma)
      sigma_min = values.get('popart_sigma_min')
      if sigma_min is not None and np.isfinite(sigma_min):
        self._good_sigma_mins.append(sigma_min)
    self._window.append(_WindowEntry(
        step=int(step), wall_time=round(time.time(), 3), values=values,
        verdict=verdict, reason=reason))
    return verdict

  @property
  def consecutive_bad(self) -> int:
    return self._consecutive_bad

  def note_external(self, kind: str, count: int = 1):
    """Record an incident another plane detected. It does not feed the
    ladder, but rides `stats`-side reports (`drain_report`)."""
    with self._external_lock:
      self._external[kind] = self._external.get(kind, 0) + int(count)

  @property
  def external_incidents(self) -> Dict[str, int]:
    with self._external_lock:
      return dict(self._external)

  def stats(self) -> Dict[str, int]:
    """Counters the loops write to summaries."""
    return {'skipped_steps': self.skipped_steps,
            'flagged_steps': self.flagged_steps,
            'rollbacks': self.rollbacks,
            'halts': self.halts,
            'sdc_mismatches': self.sdc_mismatches,
            'consecutive_bad': self._consecutive_bad}

  def drain_report(self) -> Dict:
    """Health at preemption, for resume_manifest.json: the counters and
    why the last bad step was bad (consecutive_bad > 0 explains a drain
    checkpoint withheld mid-burst)."""
    report = dict(self.stats())
    report['last_reason'] = self.last_reason
    external = self.external_incidents
    if external:
      report['external_incidents'] = external
    return report

  # --- diagnostics ---

  def write_halt_bundle(self, logdir: str, config, step: int,
                        reason: str) -> str:
    """The halt bundle: the last window of checks, the counters, the
    config and the versions, as one JSON under <logdir>/diagnostics/."""
    bundle = {
        'reason': reason,
        'step': int(step),
        'wall_time': round(time.time(), 3),
        'counters': self.stats(),
        'window': [dataclasses.asdict(e) for e in self._window],
        'config': dataclasses.asdict(config)
        if dataclasses.is_dataclass(config) else dict(config or {}),
        'versions': _versions(),
    }
    out_dir = os.path.join(logdir, 'diagnostics')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f'health_halt_step{int(step)}.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(bundle, f, indent=2, default=str)
    os.replace(tmp, path)
    return path


def _versions() -> Dict[str, str]:
  """What ran: torch, its CUDA, numpy, Python, and the card with its
  power limit when there is one."""
  versions = {'torch': torch.__version__,
              'cuda': str(torch.version.cuda),
              'numpy': np.__version__,
              'python': platform.python_version(),
              'device': 'cpu'}
  if torch.cuda.is_available():
    versions['device'] = torch.cuda.get_device_name(0)
    try:
      smi = subprocess.run(
          ['nvidia-smi', '--query-gpu=name,power.limit',
           '--format=csv,noheader'], capture_output=True, text=True,
          timeout=10)
      versions['nvidia_smi'] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
      versions['nvidia_smi'] = 'unavailable'
  return versions


def monitor_from_config(config) -> HealthMonitor:
  return HealthMonitor(
      window=config.health_window,
      min_window=config.health_min_window,
      rollback_after=config.health_rollback_after,
      max_rollbacks=config.health_max_rollbacks,
      loss_explosion_factor=config.health_loss_explosion_factor,
      sigma_divergence_factor=config.health_sigma_divergence_factor)
