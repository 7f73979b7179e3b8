"""Nothing under port_bench imports JAX or the JAX package, and the
reference imports nothing of the port; names are compared by their
top-level module, whole."""

import ast
import os
import sys

from port_bench import cells
from port_bench import run

JAX_SIDE = {'jax', 'jaxlib', 'flax', 'scalable_agent_tpu'}
PORT = 'scalable_agent_tpu_torch'


def _imports(path):
  tree = ast.parse(open(path).read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module.split('.')[0]


def _sources(directory):
  for dirpath, _, files in os.walk(directory):
    for name in files:
      if name.endswith('.py'):
        yield os.path.join(dirpath, name)


def test_no_file_imports_jax_or_the_jax_package():
  found = {(path, top) for path in _sources(cells.BENCH_DIR)
           for top in _imports(path) if top in JAX_SIDE}
  assert not found


def test_the_reference_imports_nothing_of_the_port():
  found = {(path, top)
           for path in _sources(os.path.join(cells.BENCH_DIR, 'reference'))
           for top in _imports(path) if top == PORT}
  assert not found


def test_the_check_compares_whole_top_level_names(monkeypatch):
  monkeypatch.setitem(sys.modules, 'scalable_agent_tpu_torch_x', sys)
  assert 'scalable_agent_tpu' not in run.forbidden_loaded()
  monkeypatch.setitem(sys.modules, 'jaxlib.xla_client', sys)
  assert run.forbidden_loaded() == ['jaxlib']
