"""The port's invariant analysis, after scalable_agent_tpu/analysis/: a
pluggable checker framework over the standard library's `ast`, and the
runtime half of the lock discipline.

- `analysis.runtime`: the `guarded_by` annotation and the lock-order
  checker behind `make_lock` (`OrderedLock`, armed by
  `--lock_order_check` or the LOCK_ORDER_CHECK environment variable).
- `analysis.concurrency`: the `guarded-by` AST pass, which flags reads
  and writes of annotated attributes outside a `with self.<lock>` block.
- this module: `Finding`, `CheckContext`, the `checker` registry and
  `run_checks(root)`, which runs every registered checker over the
  port's package under `root` (`python -c "from scalable_agent_tpu_torch
  import analysis; print(analysis.run_checks('.'))"` from the repo's
  root). The live port checks clean.

The contract checkers of the JAX package (`analysis/contracts.py`: metric
names, SLO objectives, controller rules, config flags, validate coverage,
protocol versions, summary scalars) read its docs and are not ported yet
(ROADMAP A7.5); until they are, the allowlists live here and are empty.

Extending: write `def check_<x>(ctx) -> List[Finding]`, register it with
`@checker('name', 'description')` in a module `_load` imports, and seed
one violation in tests/test_torch_analysis.py proving it can fire.
Import-light by design: no torch, no numpy.
"""

import ast
import dataclasses
import pathlib
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    'Finding', 'CheckContext', 'checker', 'all_checkers',
    'run_checks', 'ALLOWLISTS',
]

# The package the checkers walk, relative to the root given to
# run_checks.
PACKAGE = 'scalable_agent_tpu_torch'

# Per-check suppressions: {check: {symbol: reason}}. A finding whose
# symbol is listed is dropped; an entry that suppresses nothing is a
# finding of its own ('allowlist'). Empty: the port checks clean.
ALLOWLISTS: Dict[str, Dict[str, str]] = {}


@dataclasses.dataclass(frozen=True)
class Finding:
  """One violation: where, what, and the symbol an allowlist entry
  would name to suppress it."""
  check: str
  path: str
  line: int
  symbol: str
  message: str

  def render(self) -> str:
    return f'{self.path}:{self.line}: [{self.check}] {self.message}'


class CheckContext:
  """Repo handle shared by every checker: rooted paths, a parsed-AST
  cache (each source file is parsed once per run), and text access."""

  def __init__(self, root):
    self.root = pathlib.Path(root)
    self._trees: Dict[pathlib.Path, ast.AST] = {}
    self._texts: Dict[pathlib.Path, str] = {}

  def text(self, rel: str) -> str:
    path = self.root / rel
    if path not in self._texts:
      self._texts[path] = path.read_text()
    return self._texts[path]

  def tree(self, rel: str) -> ast.AST:
    path = self.root / rel
    if path not in self._trees:
      self._trees[path] = ast.parse(self.text(rel), filename=str(path))
    return self._trees[path]

  def package_sources(self, subdir: str = PACKAGE) -> List[str]:
    """Repo-relative paths of every .py under `subdir`, sorted."""
    base = self.root / subdir
    return sorted(
        str(p.relative_to(self.root))
        for p in base.rglob('*.py'))


# --- checker registry -------------------------------------------------

_REGISTRY: List[Tuple[str, str, Callable]] = []


def checker(name: str, description: str):
  """Register a checker. The function takes a CheckContext and
  returns a list of Findings."""
  def wrap(fn):
    _REGISTRY.append((name, description, fn))
    return fn
  return wrap


def all_checkers() -> List[Tuple[str, str, Callable]]:
  """(name, description, fn) in registration order."""
  _load()
  return list(_REGISTRY)


_loaded = False


def _load():
  """Import the checker modules exactly once (registration is an
  import side effect, kept out of package import so `analysis.runtime`
  users never pay for it)."""
  global _loaded
  if not _loaded:
    from scalable_agent_tpu_torch.analysis import concurrency  # noqa: F401
    _loaded = True


def run_checks(root, only: Optional[List[str]] = None
               ) -> List[Finding]:
  """Run the (selected) checker suite over the repo at `root`.

  Allowlist semantics: a finding whose (check, symbol) appears in
  `ALLOWLISTS` is suppressed; an allowlist entry that
  suppressed NOTHING is stale and becomes a finding itself (check
  `allowlist`) — suppressions must die with the violations they
  covered.
  """
  _load()
  ctx = CheckContext(root)
  names = {n for n, _, _ in _REGISTRY}
  if only:
    unknown = sorted(set(only) - names)
    if unknown:
      raise ValueError(
          f'unknown checker(s) {unknown}; known: {sorted(names)}')
  findings: List[Finding] = []
  used: Dict[Tuple[str, str], bool] = {
      (check, sym): False
      for check, entries in ALLOWLISTS.items()
      for sym in entries}
  selected = [e for e in _REGISTRY if not only or e[0] in only]
  for name, _, fn in selected:
    allow = ALLOWLISTS.get(name, {})
    for f in fn(ctx):
      if f.symbol in allow:
        used[(name, f.symbol)] = True
        continue
      findings.append(f)
  # Stale allowlist entries — only judged when the owning checker ran
  # (a --check run must not misread "didn't look" as "nothing found").
  ran = {e[0] for e in selected}
  for (check, sym), hit in sorted(used.items()):
    if check in ran and not hit:
      findings.append(Finding(
          check='allowlist', path=f'{PACKAGE}/analysis/__init__.py',
          line=1, symbol=f'{check}:{sym}',
          message=f'stale allowlist entry {sym!r} for check '
                  f'{check!r}: it no longer suppresses any finding — '
                  'remove it (allowlist etiquette: suppressions die '
                  'with the violations they covered)'))
  return findings
