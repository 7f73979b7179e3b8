"""The port stands alone: importing any of its modules loads no JAX, no
module of the port (nor chip_smoke.py) imports the JAX package, no code of
the port names a path inside it (so nothing of it, such as its batcher
library, is loaded), and the port holds its own batcher source."""

import ast
import os
import re
import subprocess
import sys

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
  script = ('import importlib, sys\n'
            f'for name in {modules!r}:\n'
            '  importlib.import_module(name)\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "scalable_agent_tpu"))\n'
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
  forbidden = {'scalable_agent_tpu', 'jax', 'jaxlib', 'flax', 'optax'}
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
