"""The lock-discipline AST pass, ported from
scalable_agent_tpu/analysis/concurrency.py: `guarded_by` annotations
enforced over the port's package.

A class declares, in its body,

    class InferenceServer:
      _free: guarded_by('_slot_lock')

and this pass flags every `self._free` read, write or delete in that
class's methods that is not lexically inside a `with self._slot_lock:`
block. What the checker understands:

- **Condition aliasing**: `self._not_empty =
  threading.Condition(self._lock)` makes `with self._not_empty:` count
  as holding `_lock`.
- **`*_locked` methods**: a method whose name ends in `_locked` is
  called with ONE lock already held. The checker grants it exactly one
  assumed-held lock, the one that explains the most otherwise-bare
  accesses, so a `*_locked` helper that also touches state guarded by a
  SECOND lock without taking it is still flagged.
- **`__init__` exemption**: construction happens before publication to
  other threads; the constructor writes freely.
- **Closures**: a nested function inherits the lexical held set of its
  definition site. (A closure stored and called later from outside the
  lock is invisible to a lexical pass.)

Escapes: entries in `analysis.ALLOWLISTS['guarded-by']` keyed by
`Class.method.attribute`, each with a reason.
"""

import ast
from typing import Dict, FrozenSet, List, Set, Tuple

from scalable_agent_tpu_torch.analysis import CheckContext, Finding, checker


def _self_attr(node) -> str:
  """'attr' when node is `self.attr`, else ''."""
  if (isinstance(node, ast.Attribute)
      and isinstance(node.value, ast.Name) and node.value.id == 'self'):
    return node.attr
  return ''


def _guard_decls(cls: ast.ClassDef) -> Dict[str, Tuple[str, ...]]:
  """{attr: (lock_attr, ...)} from `attr: guarded_by('lock')`
  class-body annotations."""
  guards: Dict[str, Tuple[str, ...]] = {}
  for st in cls.body:
    if not (isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)):
      continue
    ann = st.annotation
    if not isinstance(ann, ast.Call):
      continue
    fn = ann.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else '')
    if name != 'guarded_by':
      continue
    locks = tuple(a.value for a in ann.args
                  if isinstance(a, ast.Constant)
                  and isinstance(a.value, str))
    if locks:
      guards[st.target.id] = locks
  return guards


def _condition_aliases(cls: ast.ClassDef) -> Dict[str, str]:
  """{condition_attr: lock_attr} from
  `self.cond = threading.Condition(self.lock)` assignments anywhere
  in the class."""
  aliases: Dict[str, str] = {}
  for node in ast.walk(cls):
    if not isinstance(node, ast.Assign) or len(node.targets) != 1:
      continue
    tgt = _self_attr(node.targets[0])
    if not tgt or not isinstance(node.value, ast.Call):
      continue
    fn = node.value.func
    ctor = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else '')
    if ctor != 'Condition' or not node.value.args:
      continue
    src = _self_attr(node.value.args[0])
    if src:
      aliases[tgt] = src
  return aliases


class _MethodChecker:
  """Walks one method body tracking the lexical held-lock set."""

  def __init__(self, rel: str, cls: str, method: str,
               guards: Dict[str, Tuple[str, ...]],
               aliases: Dict[str, str]):
    self.rel = rel
    self.cls = cls
    self.method = method
    self.guards = guards
    self.aliases = aliases
    # (finding, acceptable-locks) pairs — the lock tuple rides along
    # so the *_locked post-pass can grant one assumed-held lock.
    self.findings: List[Tuple[Finding, Tuple[str, ...]]] = []

  def run(self, fn: ast.AST):
    self._visit_body(getattr(fn, 'body', []), frozenset())

  def _expand(self, lock: str) -> Set[str]:
    """A with on `lock` holds `lock` itself plus, for a Condition,
    the mutex it wraps."""
    held = {lock}
    if lock in self.aliases:
      held.add(self.aliases[lock])
    return held

  def _visit_body(self, body, held: FrozenSet[str]):
    for node in body:
      self._visit(node, held)

  def _visit(self, node, held: FrozenSet[str]):
    if isinstance(node, ast.With):
      inner = set(held)
      for item in node.items:
        lock = _self_attr(item.context_expr)
        if lock:
          inner |= self._expand(lock)
        else:
          self._visit(item.context_expr, held)
      self._visit_body(node.body, frozenset(inner))
      return
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
      # Closure: inherits the definition site's held set lexically.
      body = node.body if isinstance(node.body, list) else [node.body]
      self._visit_body(body, held)
      return
    if isinstance(node, ast.Attribute):
      attr = _self_attr(node)
      if attr and attr in self.guards:
        locks = self.guards[attr]
        satisfied = any(lock in held for lock in locks)
        if not satisfied:
          want = ' or '.join(f'self.{lock}' for lock in locks)
          self.findings.append((Finding(
              'guarded-by', self.rel, node.lineno,
              f'{self.cls}.{self.method}.{attr}',
              f'{self.cls}.{self.method} touches self.{attr} '
              f'(guarded_by {locks}) outside `with {want}`'), locks))
      # still visit node.value for chained attributes
      self._visit(node.value, held)
      return
    for child in ast.iter_child_nodes(node):
      self._visit(child, held)


@checker('guarded-by',
         'reads/writes of guarded_by-annotated attributes outside a '
         '`with self.<lock>` block in the owning class')
def check_guarded_by(ctx: CheckContext) -> List[Finding]:
  findings: List[Finding] = []
  for rel in ctx.package_sources():
    tree = ctx.tree(rel)
    for cls in ast.walk(tree):
      if not isinstance(cls, ast.ClassDef):
        continue
      guards = _guard_decls(cls)
      if not guards:
        continue
      aliases = _condition_aliases(cls)
      for st in cls.body:
        if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
          continue
        if st.name == '__init__':
          continue
        mc = _MethodChecker(rel, cls.name, st.name, guards, aliases)
        mc.run(st)
        raw = mc.findings
        if st.name.endswith('_locked') and raw:
          # The naming convention promises the CALLER holds one lock.
          # Grant exactly one: the candidate explaining the most
          # otherwise-bare accesses; anything it does not cover is
          # state under a DIFFERENT lock the helper must take itself.
          candidates = sorted({lock for _, locks in raw
                               for lock in locks})
          best = max(candidates,
                     key=lambda c: sum(1 for _, locks in raw
                                       if c in locks))
          raw = [(f, locks) for f, locks in raw if best not in locks]
        findings.extend(f for f, _ in raw)
  return findings
