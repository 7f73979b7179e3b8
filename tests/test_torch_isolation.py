"""The port stands alone: importing any of its modules loads no JAX and no
ml_dtypes (the card's machine has neither), no module of the port (nor
chip_smoke.py) imports the JAX package or ml_dtypes, no code of
the port names a path inside it (so nothing of it, such as its batcher
library, is loaded), and the port holds its own batcher source.

Nor does the port reach into the repo's root `scripts/` (C13): no port
source and not chip_smoke.py imports the root `scripts`, none loads a
module by path (`spec_from_file_location`), and the SLO engine's trace
slice is written by a port run whose cwd is not the repo root and whose
sys.path lacks it."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, 'scalable_agent_tpu_torch')


def _port_sources():
  paths = []
  for root, _, files in os.walk(PACKAGE):
    paths.extend(os.path.join(root, f) for f in files if f.endswith('.py'))
  return sorted(paths)


def _module_name(path):
  rel = os.path.relpath(path, REPO)[:-len('.py')].split(os.sep)
  if rel[-1] == '__init__':
    rel = rel[:-1]
  return '.'.join(rel)


def test_importing_every_port_module_loads_no_jax():
  modules = [_module_name(p) for p in _port_sources()]
  assert 'scalable_agent_tpu_torch.parallel.anakin' in modules
  # The learner extensions' modules are among them.
  assert {f'scalable_agent_tpu_torch.{name}' for name in (
      'popart', 'unreal', 'testing', 'models.instruction', 'models.lstm',
      'parallel.fit', 'envs.suites', 'envs.dmlab30', 'envs.atari57',
      'envs.anchors')} <= set(modules)
  # And evaluation's and the serving plane's.
  assert {f'scalable_agent_tpu_torch.{name}' for name in (
      'runtime.codec', 'envs.dmlab', 'envs.atari')} <= set(modules)
  # And the remote actors'.
  assert 'scalable_agent_tpu_torch.runtime.remote' in modules
  script = ('import importlib, sys\n'
            f'for name in {modules!r}:\n'
            '  importlib.import_module(name)\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "ml_dtypes", '
            '"scalable_agent_tpu"))\n'
            'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
  with open(path) as f:
    tree = ast.parse(f.read(), filename=path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module.split('.')[0]


def test_no_port_source_imports_the_jax_package():
  sources = _port_sources() + [os.path.join(REPO, 'chip_smoke.py')]
  forbidden = {'scalable_agent_tpu', 'jax', 'jaxlib', 'flax', 'optax',
               'ml_dtypes'}
  for path in sources:
    found = forbidden & set(_imported_roots(path))
    assert not found, f'{os.path.relpath(path, REPO)} imports {found}'


def _code_strings(path):
  """The string constants of a module that are not docstrings (f-string
  parts included)."""
  with open(path) as f:
    tree = ast.parse(f.read(), filename=path)
  docstrings = set()
  for node in ast.walk(tree):
    if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                         ast.AsyncFunctionDef)) and node.body:
      first = node.body[0]
      if isinstance(first, ast.Expr) and isinstance(first.value,
                                                    ast.Constant):
        docstrings.add(id(first.value))
  for node in ast.walk(tree):
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docstrings):
      yield node.lineno, node.value


def test_no_port_code_names_a_path_inside_the_jax_package():
  jax_package = re.compile(r'scalable_agent_tpu(?!_torch)')
  found = [(os.path.relpath(path, REPO), line, text)
           for path in _port_sources()
           for line, text in _code_strings(path)
           if jax_package.search(text)]
  assert not found, found


def test_the_port_holds_its_own_batcher_source():
  source = os.path.join(PACKAGE, 'ops', 'batcher', 'batcher.cc')
  assert os.path.isfile(source)
  with open(source) as f:
    text = f.read()
  for symbol in ('batcher_create', 'batcher_compute_begin',
                 'batcher_get_batch', 'batcher_set_outputs',
                 'batcher_set_error', 'batcher_close'):
    assert f'{symbol}(' in text, symbol
  from scalable_agent_tpu_torch.ops import build
  assert build.HOST_SOURCES['batcher'] == source
  assert build.host_library_path('batcher').startswith(
      os.path.join(PACKAGE, '_build') + os.sep)


def test_the_multi_process_paths_load_no_jax():
  """The registry, the TP train state, the SDC fingerprint, the unroll
  stager and the checkpoint's manifest, run (not only imported) in a
  fresh process: no JAX module loads. A spawned rank runs exactly these."""
  script = (
      'import sys, tempfile, numpy as np, torch\n'
      'from scalable_agent_tpu_torch import checkpoint, learner\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.models import ImpalaAgent\n'
      'from scalable_agent_tpu_torch.parallel import mesh, sharding\n'
      'from scalable_agent_tpu_torch.parallel import train_parallel\n'
      'from scalable_agent_tpu_torch.runtime import ring_buffer\n'
      'config = Config(batch_size=4, model_parallelism=2)\n'
      'agent = ImpalaAgent(3, (24, 32, 3), torso="shallow")\n'
      'one = mesh.Mesh(0, 1, torch.device("cpu"))\n'
      'layout = train_parallel.param_layout(agent, config,\n'
      '                                     {"data": 1, "model": 2})\n'
      'assert layout.cut_any\n'
      'fp, replicas = train_parallel.make_sdc_fingerprint_fn(one)\n'
      'assert fp(dict(agent.named_parameters())).shape == (replicas,)\n'
      'state = learner.make_train_state(agent, Config())\n'
      'with tempfile.TemporaryDirectory() as d:\n'
      '  ckpt = checkpoint.Checkpointer(d, mesh=one,\n'
      '                                 registry=layout.registry)\n'
      '  assert ckpt.save(state, force=True)\n'
      '  assert ckpt.read_sharding_manifest(0)["rule_set"] == "megatron"\n'
      'stager = ring_buffer.UnrollBatchStager(1)\n'
      'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
      '("jax", "jaxlib", "flax", "optax", "scalable_agent_tpu"))\n'
      'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


def test_the_extension_paths_load_no_jax():
  """The learner extensions run (not only imported) in a fresh process:
  the full-feature learner step with IMPACT, the replay tier with its
  CRC, the suite's levels, and the memory fit's CPU count. No JAX
  module loads."""
  script = (
      'import sys, numpy as np, torch\n'
      'from scalable_agent_tpu_torch import driver, learner\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.envs import factory\n'
      'from scalable_agent_tpu_torch.parallel import fit\n'
      'from scalable_agent_tpu_torch.runtime import ring_buffer\n'
      'from scalable_agent_tpu_torch.testing import make_example_batch\n'
      'config = Config(torso="shallow", height=24, width=32, batch_size=2,\n'
      '                unroll_length=3, level_name="dmlab30",\n'
      '                use_popart=True, pixel_control_cost=0.01,\n'
      '                surrogate="impact", replay_k=2, replay_ratio=0.5)\n'
      'levels = factory.level_names(config)\n'
      'assert len(levels) == 30\n'
      'agent = driver.build_agent(config, 5, len(levels))\n'
      'state = learner.make_train_state(agent, config, len(levels))\n'
      'batch = make_example_batch(4, 2, 24, 32, 5, 16, num_tasks=30)\n'
      'state, m = learner.make_train_step_fn(agent, config)(state, batch)\n'
      'assert {"popart_sigma_max", "pixel_control_loss",\n'
      '        "impact_clip_fraction"} <= set(m)\n'
      'tier = ring_buffer.ReplayTier(2)\n'
      'tier.add(batch)\n'
      'assert len(tier.sample(1)) == 1\n'
      'assert fit.memory_fit("cpu", batch_size=2, unroll_length=3,\n'
      '                      height=24, width=32, torso="shallow")\n'
      'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
      '("jax", "jaxlib", "flax", "optax", "scalable_agent_tpu"))\n'
      'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


def test_the_serving_and_eval_paths_load_no_jax():
  """The state arena with shed admission and int8 resident versions
  (A/B, shadow, the warm forward of serving_aot), the codec, the DMLab
  and Atari adapters over scripted backends, and restore_latest_params,
  run in a fresh process: no JAX module loads."""
  script = (
      'import sys, tempfile, threading, numpy as np, torch\n'
      'from scalable_agent_tpu_torch import checkpoint, learner\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.envs import atari, dmlab, factory\n'
      'from scalable_agent_tpu_torch.models import ImpalaAgent\n'
      'from scalable_agent_tpu_torch.runtime import codec\n'
      'from scalable_agent_tpu_torch.runtime.inference import '
      'InferenceServer\n'
      'from scalable_agent_tpu_torch.structs import StepOutput, '
      'StepOutputInfo\n'
      'agent = ImpalaAgent(3, (24, 32, 3), torso="shallow")\n'
      'params = dict(agent.named_parameters())\n'
      'config = Config(use_instruction=False, inference_state_cache=True,\n'
      '                inference_admission="shed", publish_codec="int8",\n'
      '                serving_resident_versions=3, serving_aot=True,\n'
      '                serving_ab_fraction=0.5, serving_shadow_fraction=0.5)\n'
      'server = InferenceServer(agent, params, config, fleet_size=1)\n'
      'server.warmup({"frame": (24, 32, 3), "instr_len": 16}, sizes=[1])\n'
      'server.update_params(params, version=1)\n'
      'server.update_params(params, version=2)\n'
      'handle = server.initial_core_state()\n'
      'env = StepOutput(np.float32(0), StepOutputInfo(np.float32(0), '
      'np.int32(0)), np.bool_(True), (np.zeros((24, 32, 3), np.uint8), '
      'np.zeros(16, np.int32)))\n'
      'for _ in range(4):\n'
      '  server.policy(np.int32(0), env, handle)\n'
      'assert handle.snapshot()[0].shape == (1, 256)\n'
      'assert server.stats()["aot_misses"] == 0\n'
      'server.close()\n'
      'assert codec.is_quantized(codec.quantize(params))\n'
      'for backend in ("dmlab", "atari"):\n'
      '  factory.make_env_spec(Config(env_backend=backend), "lvl", 1, '
      'is_test=True)\n'
      'state = learner.make_train_state(agent, Config())\n'
      'with tempfile.TemporaryDirectory() as d:\n'
      '  ckpt = checkpoint.Checkpointer(d)\n'
      '  assert ckpt.save(state, force=True)\n'
      '  assert ckpt.restore_latest_params(params)[1] == 0\n'
      'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
      '("jax", "jaxlib", "flax", "optax", "scalable_agent_tpu"))\n'
      'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


def _calls_named(path, name):
  """Line numbers of the calls to `name` (as `name(...)` or `x.name(...)`)
  in a module."""
  with open(path) as f:
    tree = ast.parse(f.read(), filename=path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      func = node.func
      called = (func.attr if isinstance(func, ast.Attribute) else
                func.id if isinstance(func, ast.Name) else None)
      if called == name:
        yield node.lineno


def test_c13_no_port_source_reaches_into_the_root_scripts():
  """The root `scripts/` is the JAX package's tooling: the port imports
  its own `scalable_agent_tpu_torch.scripts`, by name, and loads nothing
  by path."""
  sources = _port_sources() + [os.path.join(REPO, 'chip_smoke.py')]
  found = []
  for path in sources:
    rel = os.path.relpath(path, REPO)
    if 'scripts' in set(_imported_roots(path)):
      found.append(f'{rel} imports the root scripts')
    for line in _calls_named(path, 'spec_from_file_location'):
      found.append(f'{rel}:{line} loads a module by path')
  assert not found, found
  for name in ('trace_report', 'to_tensorboard', 'compare_torsos'):
    assert os.path.isfile(os.path.join(PACKAGE, 'scripts', f'{name}.py'))


def test_c13_the_slo_trace_slice_is_written_outside_the_repo_root(tmp_path):
  """A port importable only through its own package directory (a link to
  it in a directory of its own), run from elsewhere: the root `scripts`
  cannot be imported there, and `slo._trace_slice` still writes its slice
  of a traced logdir."""
  site = tmp_path / 'site'
  site.mkdir()
  os.symlink(PACKAGE, site / 'scalable_agent_tpu_torch')
  logdir = tmp_path / 'run'
  logdir.mkdir()
  import time
  now = time.time()
  with open(logdir / 'traces.jsonl', 'w') as f:
    for step in (1, 2, 3):
      f.write(json.dumps({
          'k': 'batch', 'step': step, 't': now - 3 + step, 'lag': [0, 1],
          'n_fresh': 1, 'spans': [{'a': 'a0', 's': step, 'bv': 0, 'h': [
              ['done', now - 4 + step], ['staged', now - 3.5 + step],
              ['serve', now - 3.2 + step], ['step', now - 3 + step]]}]})
              + '\n')
  out = tmp_path / 'slo_trace_rollbacks_zero.json'
  script = textwrap.dedent(f"""
      import json, sys
      assert {REPO!r} not in [p.rstrip('/') for p in sys.path], sys.path
      try:
        import scripts
      except ImportError:
        pass
      else:
        raise AssertionError(f'the root scripts imported: {{scripts}}')
      from scalable_agent_tpu_torch import slo
      ok = slo._trace_slice({str(logdir)!r}, 300.0, {str(out)!r},
                            {{'state': 'violated'}})
      assert ok is True, ok
      bad = sorted(m for m in sys.modules if m.split('.')[0] in
                   ('jax', 'scalable_agent_tpu', 'scripts'))
      assert not bad, bad
      """)
  env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
  env['PYTHONPATH'] = str(site)
  proc = subprocess.run([sys.executable, '-c', script], cwd=str(tmp_path),
                        env=env, capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  with open(out) as f:
    sliced = json.load(f)
  assert sliced['batches'] == 3 and sliced['unrolls'] == 3
  assert sliced['slo_objective'] == {'state': 'violated'}
  assert sliced['window_secs'] == 300.0
