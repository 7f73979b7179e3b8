"""Checkpoint and resume, ported from the JAX package's checkpoint.py.

The reference saves all global state periodically (its
MonitoredTrainingSession with save_checkpoint_secs=600) and restores the
latest on start: the network parameters, the optimizer slots and the
environment-frame counter. Actor-local state (LSTM carries, env state) is
not checkpointed, so unrolls that straddle a restart are lost, as
upstream. Here the state is the learner's TrainState: params, the RMSProp
state, `update_steps` (times frames per step, the reference's global
step), and with the extensions the PopArt statistics and IMPACT's target
network with its statistics. A health rollback reverts all of them but
the step.

The JAX package saves through Orbax; the port writes its own format with
`torch.save`, read back with `torch.load(weights_only=True)`. Neither
package reads the other's checkpoints. The layout keeps Orbax's, so the
same damage means the same thing in both:

  <dir>/<step>/default/state.pt   one committed step; the payload holds
                                  plain dicts of CPU tensors
                                  (learner.state_to_payload) and the
                                  run's torso
  <dir>/DIGEST_<step>.json        the content-digest ledger of a
                                  verified save (a CRC per file)
  <dir>/LAST_GOOD                 the newest verified step, with its
                                  digests

A step is written into a temporary directory, fsynced, and renamed into
place: the rename is the commit, as Orbax's is. The restore ladder tries
the newest retained step and falls back past one whose content digests
fail (bit rot) or whose payload does not load (a truncated or missing
file); a payload that loads but whose keys, shapes or dtypes differ from
the target's is a config mismatch and raises with the flag guidance at
once, since older steps share the config.

Under a process group (a `mesh` of more than one rank) rank 0 alone
writes; `save` and the restores are collectives that every rank calls in
the same step: the others wait for rank 0's commit, take its save
decision (`group_should_save`), and restore the step rank 0 chose. This
needs a checkpoint directory that every rank can read.

Files hold full tensors, as Orbax holds global arrays. Under tensor
parallelism (a `layout`, parallel/sharding.ParamLayout, that cuts
parameters over the mesh's model axis) the save first gathers every
rank's blocks over the model group, and a restore slices this rank's
blocks out of the full tensors, so a checkpoint restores onto any mesh.
With a `registry` each save also records the sharding manifest
(`SHARDING_<step>.json`: step, rule set, mesh, {JAX param path: spec}
and the table's digest), which the driver's elastic restore gate reads
(`saved_mesh_shape`) and a restore compares with what this run resolves
(a drift warning). `restore_resharded` is the strict cross-topology
restore.

Evaluation restores the params and the step only
(`restore_latest_params`): the step's file is memory-mapped
(`torch.load(mmap=True)`), so the RMSProp moments, PopArt statistics and
target network it also holds are never read into memory, and only the
params' tensors are copied to the device. Not here yet: the telemetry
gauges (A7.4).
"""

import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import torch

from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch import learner as learner_lib
from scalable_agent_tpu_torch.learner import TrainState
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.runtime import faults as faults_lib

log = logging.getLogger('scalable_agent_tpu_torch')

ITEM = 'default'          # Orbax's item name
PAYLOAD = 'state.pt'


class CheckpointStructureError(ValueError):
  """The latest checkpoint's tree structure does not match the state
  built from the current config (see the message for likely flags)."""


class CheckpointCorruption(RuntimeError):
  """A retained step's on-disk content does not match the digests its
  verified save recorded: bit rot after commit. The restore ladder
  treats it as damage to that step (it falls back to the previous
  retained step), never as a config mismatch; its message avoids every
  _STRUCTURE_MARKERS phrase so `_looks_structural` routes it so."""


class _UnreadableStep(RuntimeError):
  """A step whose payload could not be loaded (a truncated, missing or
  damaged file): damage to that step, which the ladder falls back past.
  Its message names the failure's type only (the error itself is the
  cause), so no marker of a structure mismatch can reach
  `_looks_structural`."""


# Markers of a tree-STRUCTURE mismatch in a restore failure's message
# (copied from the JAX package): only these earn the config-flag
# guidance. Generic words like 'missing' or 'key' also appear in
# partial-save messages, which must get the corruption wording.
_STRUCTURE_MARKERS = (
    'structure', 'tree', 'pytree', 'not found in checkpoint',
    'do not match', 'dict key mismatch')


def _looks_structural(e) -> bool:
  """Whether a restore failure looks like a tree-STRUCTURE mismatch
  (config-flag guidance, no fallback — older steps share the config)
  rather than corrupt/partial files (corruption guidance, and the
  restore ladder retries the previous retained step). KeyError is
  structural by TYPE (its str is just the missing key, which need not
  contain any marker) — EXCEPT Orbax's missing-ITEM KeyError ('Item
  "default" was not found ... Available items: []'), which means the
  step directory lost its payload (partial save/eviction): that is
  per-step damage the ladder must fall back past, not a config
  mismatch."""
  msg = str(e).lower()
  if isinstance(e, KeyError):
    return 'available items' not in msg
  return any(marker in msg for marker in _STRUCTURE_MARKERS)


def _wrap_structure_error(e, directory, step):
  """Re-raise a restore failure with the likely config-flag causes.

  The agent's param-tree STRUCTURE is a function of the config: the raw
  mismatch error names neither the flag nor the fix. The message is
  sniffed first so non-structural failures (corrupt/partial files)
  don't get misleading flag advice."""
  base = (f'could not restore checkpoint step {step} from {directory}: '
          f'{e}\n')
  if _looks_structural(e):
    guidance = (
        'This looks like a tree-structure mismatch: the param tree is '
        'a function of the config. Usual cause: --use_instruction '
        '(default None = auto by level name — a checkpoint trained '
        'with the instruction encoder needs an explicit '
        '--use_instruction=true when resumed/evaluated on a '
        'non-language level, and vice versa). Also structure-changing: '
        '--torso, --use_popart, --pixel_control_cost. Compare your '
        "flags against the run's config.json saved next to the "
        'checkpoints.')
  else:
    guidance = (
        'This does not look like a tree-structure mismatch — the '
        'checkpoint files may be corrupt or partially written (e.g. a '
        'save interrupted mid-write). Try the previous retained step, '
        'or if the config might have changed, compare your flags '
        "against the run's config.json saved next to the checkpoints.")
  raise CheckpointStructureError(base + guidance) from e


def _specs(payload) -> Dict[str, Tuple]:
  """{path: (shape, dtype)} of the tensors of a payload
  (learner.state_to_payload's layout, JAX's TrainState tree: params,
  opt_state, update_steps, and popart, target_params and target_popart
  where present). Raises when the object is not one at all."""
  specs = {}
  trees = [('params', payload['params']),
           ('opt_state/nu', payload['opt_state']['nu']),
           ('opt_state/trace', payload['opt_state']['trace'] or {})]
  trees += [(name, payload.get(name) or {})
            for name in ('popart', 'target_params', 'target_popart')]
  for prefix, tree in trees:
    specs.update({f'{prefix}/{k}': (tuple(v.shape), v.dtype)
                  for k, v in tree.items()})
  count = payload['opt_state']['count']
  specs['opt_state/count'] = (tuple(count.shape), count.dtype)
  int(payload['update_steps'])
  return specs


def _state_specs(state: TrainState) -> Dict[str, Tuple]:
  opt = state.opt_state
  as_dict = lambda p: None if p is None else p._asdict()  # noqa: E731
  return _specs({'params': state.params,
                 'opt_state': {'count': opt.count, 'nu': opt.nu,
                               'trace': opt.trace},
                 'update_steps': state.update_steps,
                 'popart': as_dict(state.popart),
                 'target_params': state.target_params,
                 'target_popart': as_dict(state.target_popart)})


def _structure_diff(want: Dict, got: Dict) -> List[str]:
  diff = [f'{k}: missing in the checkpoint' for k in sorted(set(want) - set(got))]
  diff += [f'{k}: not in the restore target' for k in sorted(set(got) - set(want))]
  diff += [f'{k}: saved {got[k]}, target {want[k]}'
           for k in sorted(set(want) & set(got)) if want[k] != got[k]]
  return diff


def _fsync_dir(path: str) -> None:
  fd = os.open(path, os.O_RDONLY)
  try:
    os.fsync(fd)
  finally:
    os.close(fd)


class Checkpointer:
  """Saves and restores the learner's TrainState under `directory`.

  Args:
    directory: checkpoint root (`<logdir>/checkpoints`).
    max_to_keep: retained steps (the oldest are pruned, with their
      digest ledgers).
    save_interval_secs: the wall-clock throttle of `maybe_save` (the
      reference's save_checkpoint_secs=600).
    verify_digests: record a CRC per file of each verified save, and
      check them before a step is trusted on restore
      (config.ckpt_digests).
    mesh: the run's mesh under a process group (parallel/mesh.py); rank
      0 writes, every rank restores the step rank 0 chose.
    registry: the run's sharding registry: each save records the
      sharding manifest.
    layout: the parameters' layout over the mesh's model axis
      (sharding.ParamLayout); the state's tensors are this rank's blocks.
    torso: the run's --torso, written into each payload; a restore
      refuses a step saved under another torso. deep and deep_fast share
      one parameter tree, so the tree alone does not tell them apart.
  """

  def __init__(self, directory: str, max_to_keep: int = 3,
               save_interval_secs: float = 600.0,
               verify_digests: bool = True, mesh=None, registry=None,
               layout: Optional[sharding.ParamLayout] = None,
               torso: Optional[str] = None):
    self._directory = os.path.abspath(directory)
    self._torso = torso
    self._group = mesh if mesh is not None and mesh.world_size > 1 else None
    self._mesh = mesh
    self._registry = registry
    self._layout = layout if layout is not None and layout.cut_any else None
    # Rank 0 writes; so under a group without a mesh (ranks training
    # replicas of one state), the others only read.
    self._primary = (mesh.world_rank if mesh is not None
                     else distributed.rank()) == 0
    if self._primary:
      os.makedirs(self._directory, exist_ok=True)
    self._max_to_keep = max_to_keep
    self._save_interval_secs = save_interval_secs
    self._last_save_time: Optional[float] = None
    self._last_good_path = os.path.join(self._directory, 'LAST_GOOD')
    self._verify_digests = bool(verify_digests)
    self.save_errors = 0
    self.last_save_error: Optional[BaseException] = None
    self.restore_fallbacks = 0
    # Steps refused for a content-digest mismatch (bit rot), counted
    # apart from the other fallbacks.
    self.digest_fallbacks = 0
    # Seconds of the last save (payload copy, write, fsync, digests)
    # and of the last restore (digests, load, copy onto the device).
    self.last_save_secs: Optional[float] = None
    self.last_restore_secs: Optional[float] = None

  # --- the group's decisions ---

  def _broadcast(self, value: int) -> int:
    """Rank 0's `value` on every rank (itself without a group). Reading
    it back waits for rank 0."""
    if self._group is None:
      return value
    tensor = torch.tensor([value], dtype=torch.int64,
                          device=self._group.device)
    return int(self._group.broadcast_(tensor, src=0)[0])

  def group_should_save(self) -> bool:
    """Rank 0's `should_save()`, the same on every rank: clocks differ
    per rank, and a save is a collective, so no rank acts on its own
    clock under a group."""
    return bool(self._broadcast(int(self.should_save())
                                if self._primary else 0))

  # --- save ---

  def all_steps(self) -> List[int]:
    """The committed steps on disk, oldest first."""
    try:
      names = os.listdir(self._directory)
    except FileNotFoundError:
      return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.isdir(os.path.join(self._directory, n)))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def _step_dir(self, step: int) -> Optional[str]:
    path = os.path.join(self._directory, str(int(step)))
    return path if os.path.isdir(path) else None

  def save(self, state: TrainState, step: Optional[int] = None,
           force: bool = False) -> bool:
    """Save now, commit, and verify. `step` defaults to the state's
    update counter.

    Returns whether a step was written and committed. An existing step is
    skipped (False, also with force=True); without `force`, so is a step
    not newer than the latest (Orbax's rule). A failed save is logged and
    counted (`save_errors`, `last_save_error`), never raised: the older
    retained steps still cover a restore. Only a save that completed
    advances LAST_GOOD. Under a group every rank calls this in the same
    step; rank 0 writes, and the others wait for its commit and return
    its result."""
    if step is None:
      step = int(state.update_steps)
    if self._layout is not None:
      state = train_parallel.gather_state(state, self._layout)
    saved = self._save_local(state, step, force) if self._primary else False
    return bool(self._broadcast(int(saved)))

  def _save_local(self, state: TrainState, step: int, force: bool) -> bool:
    steps = self.all_steps()
    if step in steps or (not force and steps and steps[-1] >= step):
      return False
    t0 = time.perf_counter()
    # Fault site 'checkpoint_save': the step is written, then damaged as
    # a save killed mid-write would leave it, and LAST_GOOD stays.
    fault = faults_lib.fire('checkpoint_save')
    try:
      nbytes = self._write_step(state, step)
    except Exception as e:
      # The throttle clock is not reset: the next maybe_save retries at
      # once.
      self.save_errors += 1
      self.last_save_error = e
      log.exception('checkpoint save at step %d FAILED (LAST_GOOD not '
                    'advanced; older retained steps remain restorable)',
                    step)
      return False
    self._last_save_time = time.monotonic()
    if fault is not None:
      damaged = faults_lib.corrupt_checkpoint_step(self._directory, step)
      self.save_errors += 1
      self.last_save_error = faults_lib.InjectedFault(
          f'checkpoint_save interrupted at step {step}')
      log.warning('injected checkpoint-save interrupt at step %d (%d '
                  'files damaged, LAST_GOOD not advanced)', step,
                  len(damaged))
      return True
    digests = self._record_digests(step)
    self._record_sharding_manifest(step, state)
    self._mark_last_good(step, digests)
    self.last_save_secs = time.perf_counter() - t0
    log.info('checkpoint step %d saved: %d bytes in %.1f ms', step, nbytes,
             1e3 * self.last_save_secs)
    # Fault site 'ckpt_bitrot': one bit flips in the step just committed,
    # after its digests were recorded and LAST_GOOD advanced.
    if faults_lib.fire('ckpt_bitrot') is not None:
      plan = faults_lib.active()
      faults_lib.bitrot_checkpoint_step(
          self._directory, step, seed=plan.seed if plan else 0)
    return True

  def _write_step(self, state: TrainState, step: int) -> int:
    """Write the step into a temporary directory, fsync it, and rename
    it into place (the commit); prune to max_to_keep. Returns the
    payload's bytes."""
    final = os.path.join(self._directory, str(step))
    tmp = os.path.join(self._directory, f'.{step}.tmp-{os.getpid()}')
    shutil.rmtree(tmp, ignore_errors=True)
    item = os.path.join(tmp, ITEM)
    os.makedirs(item)
    path = os.path.join(item, PAYLOAD)
    try:
      payload = learner_lib.state_to_payload(state)
      if self._torso is not None:
        payload['torso'] = self._torso
      with open(path, 'wb') as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
      _fsync_dir(item)
      _fsync_dir(tmp)
      nbytes = os.path.getsize(path)
      os.replace(tmp, final)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    _fsync_dir(self._directory)
    for old in self.all_steps()[:-self._max_to_keep]:
      shutil.rmtree(os.path.join(self._directory, str(old)),
                    ignore_errors=True)
    return nbytes

  # --- the content-digest ledger ---

  def _digest_path(self, step: int) -> str:
    return os.path.join(self._directory, f'DIGEST_{int(step)}.json')

  def _record_digests(self, step: int) -> Optional[Dict]:
    """Digest every file of a committed step and write the ledger
    (atomically). Returns the digests (also embedded in LAST_GOOD).
    Best-effort: a failure costs this step's bit-rot coverage only."""
    if not self._verify_digests:
      return None
    try:
      step_dir = self._step_dir(step)
      if step_dir is None:
        return None
      digests = {}
      for root, _, files in os.walk(step_dir):
        for fname in files:
          fpath = os.path.join(root, fname)
          digests[os.path.relpath(fpath, step_dir)] = (
              integrity.digest_record(integrity.file_digest(fpath)))
      tmp = self._digest_path(step) + '.tmp'
      with open(tmp, 'w') as f:
        json.dump({'step': int(step), 'algo': integrity.CRC_ALGO,
                   'files': digests}, f)
      os.replace(tmp, self._digest_path(step))
      self._prune_digests()
      return digests
    except OSError:
      log.exception('could not record content digests for step %d '
                    '(bit-rot coverage lost for this step)', step)
      return None

  def _prune_digests(self) -> None:
    """Drop the digest and sharding ledgers of steps no longer
    retained."""
    retained = {str(s) for s in self.all_steps()}
    for name in os.listdir(self._directory):
      for prefix in ('DIGEST_', 'SHARDING_'):
        if (name.startswith(prefix) and name.endswith('.json')
            and name[len(prefix):-len('.json')] not in retained):
          try:
            os.remove(os.path.join(self._directory, name))
          except OSError:
            pass

  # --- the sharding manifest ---

  def _sharding_path(self, step: int) -> str:
    return os.path.join(self._directory, f'SHARDING_{int(step)}.json')

  def _record_sharding_manifest(self, step: int, state: TrainState) -> None:
    """Record the registry's {JAX param path: spec} view of this save
    (atomic). Best-effort like the digest ledger: a failure costs this
    step's drift detection only."""
    if self._registry is None:
      return
    try:
      specs = self._registry.describe(state.params, self._mesh)
      payload = {
          'step': int(step),
          'rule_set': self._registry.rule_set,
          'mesh': (dict(self._mesh.shape) if self._mesh is not None
                   else None),
          'specs': specs,
          'digest': integrity.digest_record(
              integrity.spec_table_digest(specs)),
      }
      tmp = self._sharding_path(step) + '.tmp'
      with open(tmp, 'w') as f:
        json.dump(payload, f, indent=1)
      os.replace(tmp, self._sharding_path(step))
    except (OSError, TypeError, ValueError):
      log.exception('could not record sharding manifest for step %d '
                    '(resharding drift detection lost for this step)', step)

  def read_sharding_manifest(self, step: int) -> Optional[Dict]:
    """The recorded sharding manifest of a retained step, or None."""
    try:
      with open(self._sharding_path(step)) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def saved_mesh_shape(self) -> Optional[Dict[str, int]]:
    """The mesh the newest retained step's manifest recorded, or None
    (no steps, no manifest, or a save without a mesh)."""
    steps = self.all_steps()
    manifest = self.read_sharding_manifest(max(steps)) if steps else None
    if not manifest or not isinstance(manifest.get('mesh'), dict):
      return None
    return {str(k): int(v) for k, v in manifest['mesh'].items()}

  def _warn_sharding_drift(self, step: int, params) -> None:
    """Warn when the restored step's manifest differs from what this
    run's registry resolves for the saved tensors (`params`, full): the
    step was laid out under other rules or another mesh. The restore is
    still right (the files hold full tensors)."""
    if self._registry is None:
      return
    manifest = self.read_sharding_manifest(step)
    if manifest is None:
      return
    try:
      current = self._registry.describe(params, self._mesh)
    except Exception:
      log.exception('sharding drift check failed for step %d', step)
      return
    recorded = manifest.get('specs', {})
    if recorded == current:
      return
    changed = sorted(set(recorded.items()) ^ set(current.items()))
    log.warning(
        'checkpoint step %d was saved under sharding rule set %r (mesh %s) '
        'but this run resolves %r — %d spec(s) differ (first: %s); the '
        'full tensors were resliced onto the live layout, training '
        'continues on it', step, manifest.get('rule_set'),
        manifest.get('mesh'), self._registry.rule_set,
        len(changed) // 2 + len(changed) % 2,
        changed[0] if changed else '?')

  def verify_step_digests(self, step: int) -> Optional[bool]:
    """Re-digest a retained step against its ledger. True: verified;
    None: no ledger or another algorithm (verification skipped); raises
    CheckpointCorruption naming the first rotted or missing file."""
    if not self._verify_digests:
      return None
    try:
      with open(self._digest_path(step)) as f:
        ledger = json.load(f)
    except (OSError, ValueError):
      return None
    files = ledger.get('files')
    if not isinstance(files, dict):
      return None
    step_dir = self._step_dir(step)
    if step_dir is None:
      raise CheckpointCorruption(
          f'checkpoint step {step} has a digest ledger but no step '
          'directory on disk')
    for rel, record in sorted(files.items()):
      try:
        value = integrity.file_digest(os.path.join(step_dir, rel))
      except OSError as e:
        raise CheckpointCorruption(
            f'checkpoint step {step}: recorded file {rel!r} is '
            f'unreadable ({e}) — content verification failed')
      verdict = integrity.verify_record(record, value)
      if verdict is None:
        log.warning(
            'checkpoint step %d: digest for %r recorded with a different '
            'algorithm (%r vs local %s) — content verification skipped',
            step, rel, record, integrity.CRC_ALGO)
        return None
      if not verdict:
        raise CheckpointCorruption(
            f'checkpoint step {step}: content digest verification '
            f'failed for {rel!r} (crc {value:08x} differs from the '
            f'recorded {int(record["crc"]):08x}) — bit rot after '
            'commit; this step cannot be trusted')
    return True

  def _mark_last_good(self, step: int,
                      digests: Optional[Dict] = None) -> None:
    """Advance the LAST_GOOD marker atomically, with the verified save's
    digests embedded."""
    tmp = self._last_good_path + '.tmp'
    try:
      manifest = {'step': int(step), 'wall_time': round(time.time(), 3)}
      if digests is not None:
        manifest['digest_algo'] = integrity.CRC_ALGO
        manifest['digests'] = digests
      with open(tmp, 'w') as f:
        json.dump(manifest, f)
      os.replace(tmp, self._last_good_path)
    except OSError:
      log.exception('could not write LAST_GOOD marker for step %d', step)

  def last_good_step(self) -> Optional[int]:
    """The step LAST_GOOD names, if it is still retained."""
    try:
      with open(self._last_good_path) as f:
        step = int(json.load(f)['step'])
    except (OSError, ValueError, KeyError, TypeError):
      return None
    return step if step in self.all_steps() else None

  # --- the throttle ---

  def should_save(self) -> bool:
    """Whether the save interval has elapsed (this host's clock). The
    first call starts the clock. Under a group use
    `group_should_save`."""
    now = time.monotonic()
    if self._last_save_time is None:
      self._last_save_time = now
      return False
    return now - self._last_save_time >= self._save_interval_secs

  def maybe_save(self, state: TrainState, step: Optional[int] = None,
                 decision: Optional[bool] = None) -> bool:
    """Save iff the save interval elapsed; `decision` overrides the
    local clock (under a group: rank 0's, from group_should_save)."""
    if decision is None:
      decision = self.should_save()
    if not decision:
      return False
    return self.save(state, step)

  # --- restore ---

  def _load(self, step: int, target: TrainState) -> Dict:
    """The step's payload, checked against the target's structure."""
    path = os.path.join(self._directory, str(int(step)), ITEM, PAYLOAD)
    try:
      payload = torch.load(path, map_location='cpu', weights_only=True)
      saved = _specs(payload)
    except Exception as e:
      raise _UnreadableStep(
          f'checkpoint step {step}: its payload could not be loaded '
          f'({type(e).__name__}); the file is damaged or partially '
          'written') from e
    self._check_torso(payload.get('torso'))
    full_params = payload['params']
    if self._layout is not None:
      payload = self._localize(payload)
      saved = _specs(payload)
    diff = _structure_diff(_state_specs(target), saved)
    if diff:
      raise ValueError(
          f'the restore target and the saved tree structures do not '
          f'match ({len(diff)} difference(s); first: {"; ".join(diff[:3])})')
    self._warn_sharding_drift(step, full_params)
    return payload

  def _check_torso(self, saved: Optional[str]) -> None:
    """Refuse a step saved under another torso. A step without the
    tag predates deep_fast, so it is no deep_fast step."""
    if self._torso is None or saved == self._torso:
      return
    if saved is None and self._torso != 'deep_fast':
      return
    raise ValueError(
        f'the restore target and the saved tree structures do not match: '
        f'the step was saved under torso {saved or "(unrecorded)"!r}, the '
        f'target is torso {self._torso!r}')

  def _localize(self, payload: Dict) -> Dict:
    """The payload with this rank's blocks of the params, their moments
    and the target network in place of the full tensors (a tensor the
    layout does not know is kept whole, and the structure check then
    names it)."""
    layout = self._layout

    def local(tree):
      if tree is None:
        return None
      return {k: layout.local(k, v) if k in layout.cuts else v
              for k, v in tree.items()}

    opt = payload['opt_state']
    out = dict(payload, params=local(payload['params']),
               opt_state=dict(opt, nu=local(opt['nu']),
                              trace=local(opt['trace'])))
    if 'target_params' in payload:
      out['target_params'] = local(payload['target_params'])
    return out

  def _restore_one(self, step: int, target: TrainState) -> TrainState:
    self.verify_step_digests(step)
    return learner_lib.load_state_(target, self._load(step, target))

  def _restore_ladder(self, steps: List[int], target: TrainState,
                      restore_one=None) -> Tuple[TrainState, int]:
    """Restore down the given steps (newest first) with
    `restore_one(step)` (default: the whole state into `target`): a step
    whose digests fail or whose payload does not load is logged and the
    next is tried;
    a structure mismatch raises at once with the flag guidance; when
    every step fails, raises with the corruption guidance for the
    first failure."""
    if restore_one is None:
      restore_one = lambda step: self._restore_one(step, target)  # noqa: E731
    last_err: Optional[Tuple[int, BaseException]] = None
    for tried, step in enumerate(steps):
      try:
        restored = restore_one(step)
      except Exception as e:
        if isinstance(e, CheckpointCorruption):
          self.digest_fallbacks += 1
        elif not isinstance(e, _UnreadableStep) and _looks_structural(e):
          _wrap_structure_error(e, self._directory, step)
        log.warning(
            'checkpoint step %d failed to restore (%s: %s%s); falling '
            'back to the previous retained step', step, type(e).__name__,
            e, f' <- {e.__cause__!r}' if e.__cause__ is not None else '')
        if last_err is None:
          last_err = (step, e)
        continue
      if tried:
        self.restore_fallbacks += tried
        log.warning('restored checkpoint step %d after %d newer '
                    'corrupt/partial step(s)', step, tried)
      return restored, step
    _wrap_structure_error(last_err[1], self._directory, last_err[0])

  def _group_restore(self, local_fn, target: TrainState
                     ) -> Optional[TrainState]:
    """Rank 0 runs `local_fn` (its ladder) and broadcasts the step it
    restored (-1: none; -2: it raised); the other ranks restore that
    step."""
    if self._group is None:
      return local_fn()[0]
    if self._primary:
      try:
        restored, step = local_fn()
      except BaseException:
        self._broadcast(-2)
        raise
      self._broadcast(-1 if step is None else step)
      return restored
    step = self._broadcast(0)
    if step == -2:
      raise CheckpointStructureError(
          f'rank 0 could not restore a checkpoint from {self._directory} '
          '(see its log)')
    return None if step < 0 else self.restore_step(step, target)

  def restore_latest(self, target: TrainState) -> Optional[TrainState]:
    """Restore the newest restorable step into `target`'s tensors (see
    learner.load_state_), or None when there is none. A damaged newest
    step falls back through the older retained steps."""
    t0 = time.perf_counter()

    def local():
      steps = sorted(self.all_steps(), reverse=True)
      if not steps:
        return None, None
      return self._restore_ladder(steps, target)

    restored = self._group_restore(local, target)
    if restored is not None:
      self.last_restore_secs = time.perf_counter() - t0
    return restored

  @torch.no_grad()
  def _restore_params_one(self, step: int, params: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], int]:
    """One step's params and update_steps into `params`' tensors. The
    file is memory-mapped: of the payload, only 'params',
    'update_steps' and 'torso' are read."""
    self.verify_step_digests(step)
    path = os.path.join(self._directory, str(int(step)), ITEM, PAYLOAD)
    try:
      payload = torch.load(path, map_location='cpu', weights_only=True,
                           mmap=True)
      saved = payload['params']
      saved_specs = {f'params/{k}': (tuple(v.shape), v.dtype)
                     for k, v in saved.items()}
      update_steps = int(payload['update_steps'])
    except Exception as e:
      raise _UnreadableStep(
          f'checkpoint step {step}: its payload could not be loaded '
          f'({type(e).__name__}); the file is damaged or partially '
          'written') from e
    self._check_torso(payload.get('torso'))
    if self._layout is not None:
      saved = {k: self._layout.local(k, v) if k in self._layout.cuts
               else v for k, v in saved.items()}
      saved_specs = {f'params/{k}': (tuple(v.shape), v.dtype)
                     for k, v in saved.items()}
    diff = _structure_diff({f'params/{k}': (tuple(v.shape), v.dtype)
                            for k, v in params.items()}, saved_specs)
    if diff:
      raise ValueError(
          f'the restore target and the saved tree structures do not '
          f'match ({len(diff)} difference(s); first: {"; ".join(diff[:3])})')
    for k, v in params.items():
      v.copy_(saved[k])
    return params, update_steps

  def restore_latest_params(self, params: Dict[str, torch.Tensor]
                            ) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
    """Restore only the params and the step counter of the newest
    restorable step, through the same ladder as `restore_latest` (a
    damaged newest step falls back to the previous one): (params,
    update_steps), the params copied into `params`' own tensors on their
    device, or None when there is no step. The optimizer moments are
    never read: evaluation needs the policy weights only. Each process
    restores on its own (no group broadcast)."""
    t0 = time.perf_counter()
    steps = sorted(self.all_steps(), reverse=True)
    if not steps:
      return None
    (params, update_steps), _ = self._restore_ladder(
        steps, None, lambda step: self._restore_params_one(step, params))
    self.last_restore_secs = time.perf_counter() - t0
    return params, update_steps

  def restore_last_good(self, target: TrainState) -> Optional[TrainState]:
    """The health ladder's rollback: the step LAST_GOOD names first,
    then every other retained step, newest first. None when nothing is
    restorable (the caller then halts). Under a group every rank
    restores rank 0's `rollback_step_choice`."""
    if self._group is not None:
      choice = self._broadcast(self.rollback_step_choice()
                               if self._primary else 0)
      return self.restore_step(choice, target) if choice >= 0 else None
    steps = sorted(self.all_steps(), reverse=True)
    good = self.last_good_step()
    if good is not None:
      steps = [good] + [s for s in steps if s != good]
    if not steps:
      return None
    try:
      restored, step = self._restore_ladder(steps, target)
    except CheckpointStructureError:
      log.exception('rollback restore failed on every retained step')
      return None
    log.info('rolled back to checkpoint step %d', step)
    return restored

  def rollback_step_choice(self) -> int:
    """The step a rollback should restore: LAST_GOOD's, else the newest
    retained, else -1."""
    good = self.last_good_step()
    if good is not None:
      return good
    steps = self.all_steps()
    return max(steps) if steps else -1

  def restore_step(self, step: int, target: TrainState) -> TrainState:
    """One step, no ladder (a group's ranks all restore the same step;
    a failure raises on each). Its digests still verify first."""
    try:
      return self._restore_one(step, target)
    except Exception as e:
      _wrap_structure_error(e, self._directory, step)

  def restore_resharded(self, target: TrainState, registry, mesh,
                        strict: bool = True) -> Optional[TrainState]:
    """Restore the newest restorable step onto the layout `registry`
    resolves for `mesh` (the cross-topology restore): that layout slices
    every restore from now on. `strict` refuses with ShardingLayoutError
    when the registry resolves a cut `mesh` cannot honor for a leaf the
    save had not recorded as replicated (the manifest's table); without
    it the divisibility guard's replicated fallback is accepted."""
    full_shapes = (self._layout.full_shapes if self._layout is not None
                   else {k: tuple(v.shape) for k, v in target.params.items()})
    if strict:
      steps = self.all_steps()
      manifest = self.read_sharding_manifest(max(steps)) if steps else None
      registry.check_layout(full_shapes, mesh, what='param',
                            saved_specs=manifest.get('specs')
                            if manifest else None)
    layout = registry_restore_targets(full_shapes, registry, mesh)
    self._layout = layout if layout.cut_any else None
    return self.restore_latest(target)

  def close(self):
    """Nothing runs in the background: saves complete inside `save`."""


def registry_restore_targets(full_shapes, registry, mesh
                             ) -> sharding.ParamLayout:
  """The restore targets the registry resolves for `mesh`: the
  parameters' layout (sharding.ParamLayout of the full shapes,
  {name: shape}), by which a restore slices this rank's blocks out of
  the full tensors on disk. Fed a new mesh, it is the resharding."""
  return sharding.ParamLayout(registry, full_shapes, mesh)
