"""The port's contract checkers (scalable_agent_tpu_torch/analysis/
contracts.py), its docs (scalable_agent_tpu_torch/docs/), its lint module
(scalable_agent_tpu_torch/scripts/lint.py) and the lock discipline of its
InferenceServer, against the JAX package's.

- Every ported checker fires on a seeded violation as JAX's checker does
  on a parallel fixture (JAX's own tests/test_analysis.py fixtures, the
  paths spelled per package): the same checks, symbols and lines.
- `validate-coverage` finds fault C6 on the live driver with its repair
  taken out, in both packages.
- The contract sets parsed from the port's docs (metric names, SLO
  objectives, durable markers, protocol versions, summary-scalar tags)
  equal those parsed from the JAX package's docs, but for the listed
  differences and their reasons.
- The live port lints clean, through `run_checks` and the CLI; `--list`
  is the registry; `--fix-docs` regenerates the summary-scalar block.
- The durable-marker rule fsyncs the same incident kinds in both
  packages.
- Fault C9: the fleet loop's summary block writes JAX's sample-reuse and
  staging scalars, by JAX's formulas, from the first block on; with
  fault C10, both packages' `train` write the same tags in each block.
- Faults C7 and C8 (shared InferenceServer state touched outside its
  lock): spies on the guarded containers see every touch under the lock.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from scalable_agent_tpu import analysis as jax_analysis
from scalable_agent_tpu import observability as jax_observability
from scalable_agent_tpu.analysis import contracts as jax_contracts
from scalable_agent_tpu_torch import analysis
from scalable_agent_tpu_torch import driver as driver_lib
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.analysis import contracts
from scalable_agent_tpu_torch.analysis import runtime as lock_runtime
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.scripts import lint
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Where each package keeps what its checkers read.
_LAYOUT = {
    'jax': dict(module=jax_analysis, pkg='scalable_agent_tpu', docs='docs'),
    'port': dict(module=analysis, pkg='scalable_agent_tpu_torch',
                 docs='scalable_agent_tpu_torch/docs'),
}

# JAX's tests/test_analysis.py OBS_DOC.
_OBS_DOC = """# Observability
### Durable incident markers
`halt`
## inventory
- `x/y` — a metric.
<!-- lint:summary-scalars:begin -->
- `known_tag`
<!-- lint:summary-scalars:end -->
"""


def _mini_repo(root, files, layout):
  """Write `files` ({path: text}, both with {pkg} and {docs} spelled per
  package) under `root`; returns root as str."""
  def spelled(text):
    return text.replace('{pkg}', layout['pkg']).replace('{docs}',
                                                        layout['docs'])
  for rel, content in files.items():
    path = root / spelled(rel)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(spelled(content))
  (root / layout['pkg']).mkdir(parents=True, exist_ok=True)
  return str(root)


def _normalized(findings, layout):
  """(check, path in JAX's spelling, line, symbol) per finding."""
  def jax_path(p):
    p = p.replace(layout['docs'] + '/', 'docs/', 1)
    return p.replace(layout['pkg'] + '/', 'scalable_agent_tpu/', 1)
  return sorted((f.check, jax_path(f.path), f.line,
                 jax_path(f.symbol)) for f in findings)


def _run_both(tmp_path, check, files, port_files=None):
  out = {}
  for name, layout in _LAYOUT.items():
    chosen = files if name == 'jax' or port_files is None else port_files
    root = _mini_repo(tmp_path / name, chosen, layout)
    found = [f for f in layout['module'].run_checks(root, only=[check])
             if f.check == check]
    out[name] = _normalized(found, layout)
  return out


# --- seeded violations, held to JAX's checker -------------------------

_CONFIG_SRC = """import dataclasses
@dataclasses.dataclass
class Config:
  exposed: int = 1
  secret_knob: int = 0
INTERNAL_FIELDS = <internal>
"""
_PORT_CLI = """import argparse, dataclasses
from {pkg}.config import INTERNAL_FIELDS, Config
def _parser():
  parser = argparse.ArgumentParser()
  for field in dataclasses.fields(Config):
<skip>    parser.add_argument(f'--{field.name}')
  parser.add_argument('--device', default='cuda')
  return parser
"""
_SKIP = "    if field.name in INTERNAL_FIELDS:\n      continue\n"


def _config_src(internal):
  return _CONFIG_SRC.replace('<internal>', internal)


def _port_cli(skip):
  return _PORT_CLI.replace('<skip>', skip)


# (checker, the JAX fixture, the port's where its spelling differs, the
# symbols both must find).
_SEEDED = {
    'metric-names': (
        {'{pkg}/foo.py': "from {pkg} import telemetry\n"
                         "c = telemetry.counter('ghost/metric')\n",
         '{docs}/OBSERVABILITY.md': _OBS_DOC},
        None, {'ghost/metric', 'x/y'}),
    'slo-objectives': (
        {'{pkg}/slo.py': "DEFAULT_OBJECTIVES = (\n"
                         "    Objective(name='o1', metric='never/registered'),"
                         "\n)\n",
         '{docs}/OBSERVABILITY.md': _OBS_DOC + "| `docd` | `x/y` | v |\n"},
        None, {'o1', 'docd'}),
    'controller-rules': (
        {'{pkg}/slo.py': "DEFAULT_OBJECTIVES = (Objective(name='real',"
                         " metric='x/y'),)\n",
         '{pkg}/controller.py':
             "KNOWN_ACTUATORS = ('replay_k',)\n"
             "DEFAULT_RULES = (\n"
             "    Rule(objective='bogus', actuator='warp_drive'),\n)\n"},
        None, {'bogus', 'warp_drive'}),
    'validate-coverage': (
        {'{pkg}/config.py': "def validate_foo(config):\n  return []\n",
         '{pkg}/driver.py': "def train(config):\n  validate_foo(config)\n"
                            "def evaluate(config):\n  pass\n"},
        None, {'evaluate:validate_foo'}),
    'durable-markers': (
        {'{pkg}/observability.py':
             "class EventLog:\n"
             "  _DURABLE_MARKERS = ('halt', 'ghost_marker')\n",
         '{pkg}/driver.py': "events.event('health_halt', step=1)\n",
         '{docs}/OBSERVABILITY.md': _OBS_DOC},
        None, {'ghost_marker'}),
    'protocol-versions': (
        {'{pkg}/runtime/remote.py':
             "PROTOCOL_VERSION = 6\n_COMPATIBLE_PROTOCOLS = (5, 6, 7)\n",
         '{docs}/TRANSPORT.md': "| version |\n|---|\n| v5 |\n| v6 |\n"
                                "| v9 |\n"},
        None, {'v7', 'v9', 'v6'}),
    'summary-scalars': (
        {'{pkg}/driver.py': "def train(w):\n"
                            "  w.scalar('mystery_tag', 1.0, 0)\n"
                            "  w.scalar('known_tag', 1.0, 0)\n"
                            "  for key in ('loop_tag_a', 'known_tag'):\n"
                            "    w.scalar(key, 2.0, 0)\n",
         '{docs}/OBSERVABILITY.md': _OBS_DOC},
        None, {'mystery_tag', 'loop_tag_a'}),
    'checker-inventory': (
        {'{docs}/STATIC_ANALYSIS.md': "| `imaginary-checker` | what |\n"},
        None, None),  # the symbols: checked below
    # A stale INTERNAL_FIELDS entry (no such field), next to one that is
    # honoured: JAX's CLI defines `exposed` by hand, the port's derives
    # every field but the internal ones.
    'config-flags': (
        {'{pkg}/config.py': _config_src(
            "('stale_entry', 'secret_knob')"),
         'experiment.py': "import flags_shim as flags\n"
                          "flags.DEFINE_integer('exposed', 1, 'doc')\n"},
        {'{pkg}/config.py': _config_src(
            "('stale_entry', 'secret_knob')"),
         '{pkg}/experiment.py': _port_cli(_SKIP)},
        {'stale_entry'}),
    # An INTERNAL_FIELDS entry that has a flag all the same.
    'config-flags-flagged': (
        {'{pkg}/config.py': _config_src("('secret_knob',)"),
         'experiment.py': "import flags_shim as flags\n"
                          "flags.DEFINE_integer('exposed', 1, 'doc')\n"
                          "flags.DEFINE_integer('secret_knob', 0, 'doc')\n"},
        {'{pkg}/config.py': _config_src("('secret_knob',)"),
         '{pkg}/experiment.py': _port_cli('')},
        {'secret_knob'}),
    # No CI wiring, and a checker run inline: JAX's CI shell script
    # against the port's chip_smoke.py.
    'ci-wiring': (
        {'scripts/ci.sh': "python - <<'LINT_EOF'\nLINT_EOF\n"},
        {'chip_smoke.py': "from {pkg} import analysis\n"
                          "print(analysis.run_checks('.'))\n"},
        {'lint-call', 'inline'}),
    # Every spelling the checker must see, in a module, in functions, and
    # the registry's own module exempt.
    'sharding-registry': (
        {'{pkg}/rogue.py': "from jax.sharding import PartitionSpec as P\n"
                           "def place():\n  return P(None, 'model')\n",
         '{pkg}/rogue2.py': "import jax.sharding\n"
                            "spec = jax.sharding.PartitionSpec('data')\n",
         '{pkg}/rogue3.py': "from jax.sharding import NamedSharding\n"
                            "def pin(mesh, spec):\n"
                            "  return NamedSharding(mesh, spec)\n",
         '{pkg}/parallel/sharding.py':
             "from jax.sharding import PartitionSpec as P\nHOME = P('data')\n"},
        {'{pkg}/rogue.py':
             "from {pkg}.parallel.sharding import ShardingRegistry as R\n"
             "def place():\n  return R(())\n",
         '{pkg}/rogue2.py': "from {pkg}.parallel import sharding\n"
                            "registry = sharding.ShardingRegistry(())\n",
         '{pkg}/rogue3.py': "from {pkg}.parallel.sharding import "
                            "ShardingRegistry\n"
                            "def pin(rules):\n"
                            "  return ShardingRegistry(rules)\n",
         '{pkg}/parallel/sharding.py':
             "class ShardingRegistry:\n  pass\n"
             "def from_config(config):\n  return ShardingRegistry()\n"},
        {'scalable_agent_tpu/rogue.py:place',
         'scalable_agent_tpu/rogue2.py:<module>',
         'scalable_agent_tpu/rogue3.py:pin'}),
}


@pytest.mark.parametrize('case', sorted(_SEEDED))
def test_each_checker_fires_on_its_seed_as_jax_s_does(tmp_path, case):
  check = case if case != 'config-flags-flagged' else 'config-flags'
  files, port_files, symbols = _SEEDED[case]
  got = _run_both(tmp_path, check, files, port_files)
  if port_files is None:
    # The same fixture: the same findings, line for line.
    assert got['port'] == got['jax']
  jax_symbols = {f[3] for f in got['jax']}
  port_symbols = {f[3] for f in got['port']}
  if case == 'ci-wiring':
    # JAX's heredoc and the port's inline run are one offence.
    jax_symbols = {s.replace('inline-heredoc', 'inline') for s in
                   jax_symbols}
    port_symbols = {s.replace('inline-checker', 'inline') for s in
                    port_symbols}
  assert port_symbols == jax_symbols
  if case == 'checker-inventory':
    registered = {n for n, _, _ in analysis.all_checkers()}
    symbols = registered | {'imaginary-checker'}
    assert registered == {n for n, _, _ in jax_analysis.all_checkers()}
  assert port_symbols == symbols


def test_config_flags_holds_the_port_s_derivation(tmp_path):
  layout = _LAYOUT['port']
  base = {'{pkg}/config.py': _config_src('()')}
  cases = {
      # The derivation: every field a flag, --device no field.
      'derived': (_port_cli(''), set()),
      # No derivation: each field lacks a flag.
      'none': ("import argparse\np = argparse.ArgumentParser()\n"
               "p.add_argument('--device')\n", {'exposed', 'secret_knob'}),
      # A field's flag spelled by hand beside the derivation.
      'by_hand': (_port_cli('') +
                  "_parser().add_argument('--exposed')\n", {'exposed'}),
  }
  for name, (cli, want) in cases.items():
    root = _mini_repo(tmp_path / name,
                      dict(base, **{'{pkg}/experiment.py': cli}), layout)
    found = analysis.run_checks(root, only=['config-flags'])
    assert {f.symbol for f in found} == want, name
  assert any('by hand' in f.message for f in found)


def test_summary_scalars_reads_the_port_s_scalars_dicts(tmp_path):
  root = _mini_repo(tmp_path, {
      '{pkg}/driver.py':
          "def train(w, s):\n"
          "  w.scalars({'dict_tag': 1.0, 'known_tag': s['x']}, 0)\n"
          "  w.scalars({k: s[k] for k in ('comp_a', 'comp_b') if k in s},"
          " 0)\n"
          "  w.scalars({k: v for k, v in s.items()}, 0)\n",
      '{docs}/OBSERVABILITY.md': _OBS_DOC}, _LAYOUT['port'])
  found = analysis.run_checks(root, only=['summary-scalars'])
  assert {f.symbol for f in found} == {'dict_tag', 'comp_a', 'comp_b'}
  assert contracts.fix_summary_scalar_docs(analysis.CheckContext(root))
  assert analysis.run_checks(root, only=['summary-scalars']) == []


def test_validate_coverage_finds_c6_in_the_driver_without_its_repair(
    tmp_path):
  """Fault C6: each package's live config and driver, the driver's calls
  of validate_distributed renamed away (the port's parent tree called it
  from neither train nor evaluate)."""
  for name, layout in _LAYOUT.items():
    pkg = layout['pkg']
    root = tmp_path / name
    (root / pkg).mkdir(parents=True)
    shutil.copy(os.path.join(REPO_ROOT, pkg, 'config.py'), root / pkg)
    with open(os.path.join(REPO_ROOT, pkg, 'driver.py')) as f:
      driver = f.read()
    assert driver.count('validate_distributed(') >= 2
    (root / pkg / 'driver.py').write_text(
        driver.replace('validate_distributed(', 'unrepaired('))
    found = layout['module'].run_checks(str(root),
                                        only=['validate-coverage'])
    assert {f.symbol for f in found} == {
        'train:validate_distributed', 'evaluate:validate_distributed'}, name
  # The live drivers are clean.
  assert analysis.run_checks(REPO_ROOT, only=['validate-coverage']) == []


# --- the port's docs against the JAX package's ------------------------

_JAX_CTX = jax_analysis.CheckContext(REPO_ROOT)
_PORT_CTX = analysis.CheckContext(REPO_ROOT)

# Summary scalars the port writes and JAX does not, and the other way,
# each with its reason.
_PORT_ONLY_TAGS = {
    'halts': 'the health ladder\'s halt count beside its skipped, '
             'flagged and rollback counts',
    'prefetch_wait_secs': 'the prefetcher\'s cumulative feed wait, the '
                          'raw input of staging_exposed_ms_per_step',
    'batch_serves': 'the prefetcher\'s serve count (sample reuse)',
    'batch_reserves': 'the prefetcher\'s whole-batch re-serves, an input '
                      'of frames_reused',
    'fresh_slots_served': 'the prefetcher\'s fresh slots, the input of '
                          'frames_fresh',
}
_JAX_ONLY_TAGS = {
    'staging_donation_fallback': 'XLA buffer donation falling back to a '
                                 'copy; the port donates no buffers',
}


def _jax_doc(name):
  return _JAX_CTX.text(f'docs/{name}')


def test_the_port_s_docs_hold_jax_s_contracts():
  assert (contracts.documented_metric_names(_PORT_CTX) ==
          jax_contracts._documented_metric_names(_JAX_CTX))
  jax_objectives = set(re.findall(
      r'^\|\s*`([a-z0-9_]+)`\s*\|\s*`[a-z0-9_]+(?:/[a-z0-9_]+)+`',
      _jax_doc('OBSERVABILITY.md'), re.MULTILINE))
  assert contracts.documented_objectives(_PORT_CTX) == jax_objectives
  assert (contracts.documented_durable_markers(_PORT_CTX) ==
          jax_contracts._doc_durable_markers(_JAX_CTX))
  jax_versions = {int(v) for v in re.findall(
      r'^\|\s*v(\d+)\s*\|', _jax_doc('TRANSPORT.md'), re.M)}
  assert contracts.documented_protocol_versions(_PORT_CTX) == jax_versions
  port_tags = contracts.documented_summary_tags(_PORT_CTX)
  jax_tags = jax_contracts.documented_summary_tags(_JAX_CTX)
  assert port_tags - jax_tags == set(_PORT_ONLY_TAGS)
  assert jax_tags - port_tags == set(_JAX_ONLY_TAGS)


def test_the_port_s_code_holds_jax_s_contract_literals():
  assert (observability.EventLog._DURABLE_MARKERS ==
          jax_observability.EventLog._DURABLE_MARKERS)
  assert ([n for n, _, _ in contracts.slo_defaults(_PORT_CTX)] ==
          [n for n, _, _ in jax_contracts._slo_defaults(_JAX_CTX)])
  assert (set(contracts.registered_metric_names(_PORT_CTX)) ==
          set(jax_contracts.registered_metric_names(_JAX_CTX)))


@pytest.mark.parametrize('kind', [
    'rollback', 'health_halt', 'slo_violation', 'controller_action',
    'host_left', 'pbt_exploit', 'actors_respawned', 'wire_crc_rejected',
    'filler_skipped_updates'])
def test_the_same_kinds_are_fsynced(tmp_path, monkeypatch, kind):
  synced = {}
  real_fsync = os.fsync
  for name, module in (('jax', jax_observability),
                       ('port', observability)):
    calls = []
    monkeypatch.setattr(os, 'fsync', lambda fd, calls=calls: (
        calls.append(fd), real_fsync(fd)))
    log = module.EventLog(str(tmp_path / name))
    log.event(kind, step=3, detail='x')
    log.close()
    synced[name] = len(calls)
    with open(tmp_path / name / 'incidents.jsonl') as f:
      assert f.read().count(kind) == 1
  assert synced['port'] == synced['jax']
  assert synced['port'] == (1 if any(
      m in kind for m in observability.EventLog._DURABLE_MARKERS) else 0)


class _Recorder:
  """A summary writer that keeps each block's scalars."""

  def __init__(self):
    self.blocks = []

  def scalars(self, values, step):
    self.blocks.append((step, dict(values)))


class _Stats:
  def __init__(self, **stats):
    self.now = stats

  def stats(self, **_):
    return self.now


def test_c9_the_plane_split_writes_jax_s_reuse_and_staging_scalars(
    monkeypatch):
  """Fault C9: the fleet loop's summaries carry JAX's sample-reuse and
  staging scalars, by JAX's formulas (scalable_agent_tpu/driver.py's
  summary block), in every block: the first interval runs from the
  loop's start, as JAX's snapshots are seeded there."""
  clock = iter([97.5, 100.0, 102.5])
  monkeypatch.setattr(driver_lib.time, 'monotonic', lambda: next(clock))
  frames_per_unroll, local_batch = 20, 4
  planes = driver_lib._PlaneSplit(2, frames_per_unroll=frames_per_unroll,
                                  local_batch_size=local_batch)
  writer = _Recorder()
  buffer = _Stats(put_wait_secs=1.0, replay_reused_unrolls=3)
  prefetcher = _Stats(wait_secs=0.5, fresh_slots_served=8, gets=4,
                      batch_reserves=1, mode='batch')
  fleet = _Stats(healthy_fraction=1.0)
  planes.write(writer, 10, buffer, prefetcher, fleet, None, None, steps_done=4)
  buffer.now = dict(put_wait_secs=2.0, replay_reused_unrolls=5)
  prefetcher.now = dict(wait_secs=1.5, fresh_slots_served=16, gets=9,
                        batch_reserves=2, mode='unroll')
  planes.write(writer, 20, buffer, prefetcher, fleet, None, None, steps_done=9)
  assert [step for step, _ in writer.blocks] == [10, 20]
  first, last = (values for _, values in writer.blocks)
  for values in (first, last):
    assert {'frames_fresh', 'frames_reused', 'staging_unroll_active',
            'learner_updates_per_env_frame', 'env_frames_fresh_per_sec',
            'staging_exposed_ms_per_step', 'learner_plane_utilization',
            'env_plane_utilization'} == set(values)
  # The first interval, against the zero snapshot taken at 97.5.
  assert first['frames_fresh'] == 8 * frames_per_unroll
  assert first['frames_reused'] == (3 + 1 * local_batch) * frames_per_unroll
  assert first['staging_unroll_active'] == 0.0
  assert first['learner_updates_per_env_frame'] == 4 / (8 * frames_per_unroll)
  assert first['env_frames_fresh_per_sec'] == 8 * frames_per_unroll / 2.5
  assert first['staging_exposed_ms_per_step'] == 0.5 / 4 * 1e3
  assert first['learner_plane_utilization'] == 1.0 - 0.5 / 2.5
  assert first['env_plane_utilization'] == 1.0 - 1.0 / (2.5 * 2)
  d_fresh_frames = (16 - 8) * frames_per_unroll
  assert last['frames_fresh'] == 16 * frames_per_unroll
  assert last['frames_reused'] == (5 + 2 * local_batch) * frames_per_unroll
  assert last['staging_unroll_active'] == 1.0
  assert last['learner_updates_per_env_frame'] == (9 - 4) / d_fresh_frames
  assert last['env_frames_fresh_per_sec'] == d_fresh_frames / 2.5
  assert last['staging_exposed_ms_per_step'] == (1.5 - 0.5) / (9 - 4) * 1e3
  assert last['learner_plane_utilization'] == 1.0 - 1.0 / 2.5
  assert last['env_plane_utilization'] == 1.0 - 1.0 / (2.5 * 2)


# Summary scalars whose value both packages' loops fix on this run's
# inputs: the step and frame counts, the staging mode and the health
# ladder's counters. The losses and the learning rate differ (each
# package's own initialisation; JAX writes the previous step's learner
# metrics, its one-step-delayed read), and the rates, waits and
# latencies are the host's timing.
_DETERMINISTIC_TAGS = (
    'frames_fresh', 'frames_reused', 'staging_unroll_active',
    'learner_updates_per_env_frame', 'sdc_replica_mismatches',
    'skipped_steps', 'flagged_steps', 'rollbacks', 'params_version',
    'checkpoint_save_errors', 'actors_alive', 'slots_quarantined')


def _summary_blocks(logdir):
  blocks = {}
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    for line in f:
      event = json.loads(line)
      blocks.setdefault(event['step'], {})[event['tag']] = event.get('value')
  return blocks


def test_c9_both_trains_write_the_same_summary_tags_in_every_block(
    tmp_path):
  """Faults C9 and C10 end to end: JAX's and the port's fleet `train` on
  one CPU bandit config, two steps at summary_secs=0, so one block after
  one step and a second after two. Each block holds the same tags in
  both packages (but the listed port-only ones), with equal values
  wherever this run's inputs fix them. C10: the port wrote
  `sdc_replica_mismatches` only with the SDC sentinel on; JAX writes it
  whenever the health monitor runs."""
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig
  kw = dict(env_backend='bandit', num_actors=2, batch_size=2,
            unroll_length=5, num_action_repeats=1, episode_length=4,
            height=24, width=32, torso='shallow', use_py_process=False,
            use_instruction=False, total_environment_frames=10**6,
            inference_timeout_ms=5, summary_secs=0, seed=3)
  blocks = {}
  for name, train in (
      ('jax', lambda logdir: jax_driver.train(
          JaxConfig(**kw, logdir=logdir), max_steps=2)),
      ('port', lambda logdir: driver_lib.train(
          Config(**kw, logdir=logdir), max_steps=2, device='cpu'))):
    train(str(tmp_path / name))
    blocks[name] = _summary_blocks(str(tmp_path / name))
  assert sorted(blocks['jax']) == sorted(blocks['port']) == [1, 2]
  for step in (1, 2):
    jax_block, port_block = blocks['jax'][step], blocks['port'][step]
    assert set(port_block) - set(jax_block) == set(_PORT_ONLY_TAGS)
    assert set(jax_block) - set(port_block) <= set(_JAX_ONLY_TAGS)
    for tag in _DETERMINISTIC_TAGS:
      assert port_block[tag] == jax_block[tag], (step, tag)
    for tag in ('learner_plane_utilization', 'env_plane_utilization'):
      assert 0.0 <= port_block[tag] <= 1.0
    for tag in ('env_frames_fresh_per_sec', 'staging_exposed_ms_per_step'):
      assert port_block[tag] >= 0.0
  assert blocks['port'][1]['frames_fresh'] == 2 * 5
  assert blocks['port'][2]['learner_updates_per_env_frame'] == 1 / (2 * 5)


# --- the live port and the CLI ----------------------------------------


def _cli(argv):
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = lint.main(argv)
  return rc, out.getvalue(), err.getvalue()


def test_the_live_port_lints_clean_through_the_cli():
  # Every checker over the live tree: test_torch_analysis.py's
  # test_the_live_port_checks_clean; here the CLI's exits on a subset.
  checks = ['--check', 'config-flags', '--check', 'protocol-versions',
            '--check', 'summary-scalars', '--check', 'checker-inventory']
  rc, out, err = _cli(checks)
  assert (rc, out) == (0, ''), out
  assert 'lint OK: 4 checker(s), no findings' in err
  rc, out, _ = _cli(['--json'] + checks)
  assert (rc, out.strip()) == (0, '[]')
  assert _cli(['--check', 'no-such-checker'])[0] == 2


def test_list_is_the_registry():
  rc, out, _ = _cli(['--list'])
  assert rc == 0
  listed = [line.split(':', 1)[0] for line in out.splitlines()]
  assert listed == [n for n, _, _ in analysis.all_checkers()]
  assert sorted(listed) == sorted(
      n for n, _, _ in jax_analysis.all_checkers())


def test_the_cli_exits_1_on_findings_and_fix_docs_repairs_them(tmp_path):
  root = _mini_repo(tmp_path, {
      '{pkg}/driver.py': "def train(w):\n  w.scalar('fresh_tag', 1.0, 0)\n",
      '{docs}/OBSERVABILITY.md': _OBS_DOC}, _LAYOUT['port'])
  rc, out, _ = _cli(['--root', root, '--check', 'summary-scalars',
                     '--json'])
  assert rc == 1 and '"fresh_tag"' in out
  rc, _, err = _cli(['--root', root, '--check', 'summary-scalars',
                     '--fix-docs'])
  assert rc == 0 and 'REGENERATED' in err


# --- InferenceServer's lock discipline: faults C7 and C8 --------------

_H, _W = 24, 32
_AGENT = ImpalaAgent(3, (_H, _W, 3), torso='shallow')
_PARAMS = {k: v.detach().clone() for k, v in init_params(
    _AGENT, torch.Generator().manual_seed(0)).items()}


class _Guard:
  """Records each touch of a guarded container made while this thread
  does not hold the server's `_lock` ('inference._params_lock')."""

  def __init__(self):
    self.bare = []

  def touch(self, what):
    if 'inference._params_lock' not in lock_runtime._held_names():
      self.bare.append(what)


def _spy_list(guard, items, label):
  class Spy(list):
    def append(self, x):
      guard.touch(f'{label}.append')
      super().append(x)

    def __len__(self):
      guard.touch(f'len({label})')
      return super().__len__()
  return Spy(items)


def _spy_set(guard, items, label):
  class Spy(set):
    def add(self, x):
      guard.touch(f'{label}.add')
      super().add(x)

    def __contains__(self, x):
      guard.touch(f'in {label}')
      return super().__contains__(x)

    def __iter__(self):
      guard.touch(f'iter({label})')
      return super().__iter__()
  return Spy(items)


@pytest.fixture
def armed_server():
  was_armed = lock_runtime.is_armed()
  lock_runtime.arm()
  servers = []

  def make(**kw):
    config = Config(inference_max_batch=8, inference_timeout_ms=5,
                    use_instruction=False, **kw)
    servers.append(InferenceServer(_AGENT, _PARAMS, config, seed=7,
                                   fleet_size=1, pad_batch_to=1))
    return servers[-1]
  yield make
  for server in servers:
    server.close()
  lock_runtime.arm(was_armed)


def _act(server):
  frame = np.zeros((_H, _W, 3), np.uint8)
  env = StepOutput(np.float32(0.0), StepOutputInfo(np.float32(0),
                                                   np.int32(0)),
                   np.bool_(False), (frame, np.zeros(16, np.int32)))
  out, _ = server.policy(np.int32(0), env, server.initial_core_state())
  return int(out.action)


def test_c7_the_snapshot_pool_is_touched_under_the_lock(armed_server):
  server = armed_server()
  guard = _Guard()
  server._snapshots = _spy_list(guard, server._snapshots, '_snapshots')
  for version in (1, 2, 3):  # each makes or reuses a snapshot
    server.update_params(_PARAMS, version=version)
  assert server.stats()['snapshots'] >= 2
  assert guard.bare == []


def test_c8_the_warmed_pairs_are_touched_under_the_lock(armed_server):
  server = armed_server(serving_aot=True, publish_codec='int8')
  guard = _Guard()
  server._warmed = _spy_set(guard, server._warmed, '_warmed')
  server._warm_buckets = _spy_set(guard, server._warm_buckets,
                                  '_warm_buckets')
  server.warmup({'frame': (_H, _W, 3), 'instr_len': 16}, sizes=[1])
  server.update_params(_PARAMS, version=1)  # a new (int8) structure
  _act(server)  # the dispatch thread's serve check
  stats = server.stats()
  assert stats['aot_compiled'] >= 2 and stats['aot_misses'] == 0
  assert guard.bare == []
