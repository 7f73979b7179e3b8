"""The port's checker framework and guarded-by pass
(scalable_agent_tpu_torch/analysis/) against the JAX package's.

The same seeded fixtures go into a minimal repo under each package's
root and through both packages' `run_checks`: the findings agree apart
from the root. Then the port's `run_checks` over the live repo returns
nothing, the framework's own rules hold (unknown checkers raise, a stale
allowlist entry is a finding), and every class annotated with
`guarded_by` in the port is one the checker walked.
"""

import ast
import dataclasses
import os

import pytest

from scalable_agent_tpu import analysis as jax_analysis
from scalable_agent_tpu_torch import analysis
from scalable_agent_tpu_torch.analysis import concurrency

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's tests/test_analysis.py fixture, the import spelled per package.
_WIDGET = """import threading
from {package}.analysis.runtime import guarded_by

class Widget:
  _items: guarded_by('_lock')
  _meta: guarded_by('_meta_lock')

  def __init__(self):
    self._lock = threading.Lock()
    self._cv = threading.Condition(self._lock)
    self._meta_lock = threading.Lock()
    self._items = []          # __init__ is exempt
    self._meta = None

  def good(self):
    with self._lock:
      self._items.append(1)

  def good_via_condition(self):
    with self._cv:
      return len(self._items)   # Condition aliases the mutex

  def good_closure(self):
    with self._lock:
      def peek():
        return self._items[-1]  # inherits the lexical held-set
      return peek()

  def _drain_locked(self):
    return self._items.pop()    # caller-held lock: exempt

  def _mixed_locked(self):
    self._items.append(3)       # caller-held lock: exempt
    self._meta = 'x'            # VIOLATION: a second lock's state

  def bad_read(self):
    return len(self._items)     # VIOLATION: no lock

  def bad_wrong_lock(self):
    with self._meta_lock:
      self._items.append(2)     # VIOLATION: wrong lock held
"""

# More shapes: two locks named for one attribute, a bare closure that
# escapes the lock, a delete, a nested class with its own guards, and a
# *_locked helper whose only accesses are under a second lock.
_QUEUE = """import threading
from {package}.analysis.runtime import guarded_by

class Queue:
  _depth: guarded_by('_lock', '_alt_lock')
  _log: guarded_by('_log_lock')

  def __init__(self):
    self._lock = threading.RLock()
    self._alt_lock = threading.Lock()
    self._log_lock = threading.Lock()
    self._not_empty = threading.Condition(self._lock)
    self._depth = 0
    self._log = []

  def either(self):
    with self._alt_lock:
      self._depth += 1

  def escape(self):
    def later():
      return self._depth        # VIOLATION: the closure holds nothing
    with self._lock:
      return later

  def forget(self):
    del self._log[:]            # VIOLATION: a delete outside the lock

  def wait_for_items(self):
    with self._not_empty:
      while not self._depth:
        self._not_empty.wait()
      with self._log_lock:
        self._log.append('got')

  def _log_locked(self):
    self._log.append(1)         # the one granted lock: _log_lock

  def _two_locked(self):
    self._log.append(2)         # granted
    self._log.append(3)         # granted
    return self._depth          # VIOLATION: the grant went to _log_lock

  class Inner:
    _x: guarded_by('_m')

    def __init__(self):
      self._m = threading.Lock()
      self._x = 0

    def peek(self):
      return self._x            # VIOLATION: no lock
"""


def _mini_repo(tmp_path, package, files):
  for rel, content in files.items():
    path = tmp_path / package / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content.format(package=package))
  return str(tmp_path)


def _findings(module, root, package):
  """(check, path below the package, line, symbol, message) per finding."""
  return sorted(
      (f.check, os.path.relpath(f.path, package), f.line, f.symbol,
       f.message)
      for f in module.run_checks(root, only=['guarded-by']))


@pytest.mark.parametrize('fixture', ['widget', 'queue', 'both'])
def test_seeded_fixtures_fire_as_in_jax(tmp_path, fixture):
  files = {'widget': {'widget.py': _WIDGET}, 'queue': {'sub/queue.py': _QUEUE}}
  files['both'] = dict(files['widget'], **files['queue'])
  want = _findings(jax_analysis,
                   _mini_repo(tmp_path / 'jax', 'scalable_agent_tpu',
                              files[fixture]), 'scalable_agent_tpu')
  got = _findings(analysis,
                  _mini_repo(tmp_path / 'port', 'scalable_agent_tpu_torch',
                             files[fixture]), 'scalable_agent_tpu_torch')
  assert got == want
  symbols = sorted(f[3] for f in got)
  expected = {
      'widget': ['Widget._mixed_locked._meta', 'Widget.bad_read._items',
                 'Widget.bad_wrong_lock._items'],
      'queue': ['Inner.peek._x', 'Queue._two_locked._depth',
                'Queue.escape._depth', 'Queue.forget._log'],
  }
  expected['both'] = sorted(expected['widget'] + expected['queue'])
  assert symbols == expected[fixture]


def test_the_live_port_checks_clean():
  findings = analysis.run_checks(REPO_ROOT)
  assert findings == [], '\n'.join(f.render() for f in findings)
  assert [name for name, _, _ in analysis.all_checkers()] == ['guarded-by']


def test_the_checker_walks_every_annotated_class_of_the_port():
  """Every class that declares guarded_by in the port is one the checker
  parses, and those declarations are the ones `_guard_decls` reads."""
  ctx = analysis.CheckContext(REPO_ROOT)
  sources = ctx.package_sources()
  assert 'scalable_agent_tpu_torch/controller.py' in sources
  declared = {}
  for rel in sources:
    for cls in ast.walk(ctx.tree(rel)):
      if isinstance(cls, ast.ClassDef):
        guards = concurrency._guard_decls(cls)
        if guards:
          declared[(rel, cls.name)] = guards
  assert declared[('scalable_agent_tpu_torch/controller.py',
                   'Controller')] == {
      '_actions': ('_lock',), '_owner': ('_lock',),
      '_dropped_actions': ('_lock',)}
  assert declared[('scalable_agent_tpu_torch/slo.py', 'SloEngine')] == {
      '_captures': ('_lock',), '_profile_queue': ('_lock',),
      '_capture_queue': ('_lock',)}
  assert sum(map(len, declared.values())) >= 51


def test_unknown_checker_name_raises():
  with pytest.raises(ValueError, match='unknown checker'):
    analysis.run_checks(REPO_ROOT, only=['not-a-checker'])


def test_a_stale_allowlist_entry_is_a_finding(tmp_path, monkeypatch):
  root = _mini_repo(tmp_path, 'scalable_agent_tpu_torch',
                    {'widget.py': _WIDGET})
  monkeypatch.setitem(analysis.ALLOWLISTS, 'guarded-by', {
      'Widget.bad_read._items': 'seeded',
      'Widget.gone._items': 'covers nothing'})
  findings = analysis.run_checks(root)
  symbols = sorted(f.symbol for f in findings)
  assert symbols == ['Widget._mixed_locked._meta',
                     'Widget.bad_wrong_lock._items',
                     'guarded-by:Widget.gone._items']
  stale = [f for f in findings if f.check == 'allowlist']
  assert stale[0].path == 'scalable_agent_tpu_torch/analysis/__init__.py'


def test_the_framework_s_types_are_jax_s():
  assert ([f.name for f in dataclasses.fields(analysis.Finding)] ==
          [f.name for f in dataclasses.fields(jax_analysis.Finding)])
  finding = analysis.Finding('guarded-by', 'p.py', 3, 'A.b.c', 'msg')
  assert finding.render() == jax_analysis.Finding(
      'guarded-by', 'p.py', 3, 'A.b.c', 'msg').render()
