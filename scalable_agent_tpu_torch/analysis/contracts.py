"""Contract checkers: the literal-string contracts that hold the port's
fleet together, checked in both directions. The port of the JAX
package's analysis/contracts.py, over the port's own modules and its own
docs (`scalable_agent_tpu_torch/docs/`):

- `metric-names`: telemetry registrations <-> the OBSERVABILITY.md
  inventory;
- `slo-objectives`: `slo.DEFAULT_OBJECTIVES` <-> registered metrics and
  the OBSERVABILITY.md SLO table;
- `controller-rules`: `controller.DEFAULT_RULES` <-> the shipped
  objectives and `KNOWN_ACTUATORS`;
- `config-flags`: `Config` fields <-> the CLI's flags (the port derives
  one flag per field, experiment.py) and `config.INTERNAL_FIELDS`;
- `validate-coverage`: every `config.validate_*` group is called from
  both `driver.train` and `driver.evaluate`;
- `durable-markers`: `EventLog._DURABLE_MARKERS` <-> the incident kinds
  the port emits and the OBSERVABILITY.md marker list;
- `protocol-versions`: remote.py's `_COMPATIBLE_PROTOCOLS` <-> the
  TRANSPORT.md version table;
- `summary-scalars`: the driver's summary-scalar tags <-> the generated
  block of OBSERVABILITY.md (`python -m scalable_agent_tpu_torch.scripts.
  lint --fix-docs` regenerates it);
- `checker-inventory`: the registry <-> the STATIC_ANALYSIS.md table;
- `ci-wiring`: chip_smoke.py, the port's CI on the card, runs the lint
  module and copies no checker inline;
- `sharding-registry`: no `ShardingRegistry(...)` built outside
  parallel/sharding.py.

Every checker is the standard library's `ast` plus regexes over the docs:
literal registration and emission is the convention that makes them
static (a name built at run time is invisible here, and so is not used on
these surfaces).
"""

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from scalable_agent_tpu_torch.analysis import (PACKAGE, CheckContext,
                                               Finding, checker)

# Per-check suppressions: {check: {symbol: reason}}. Every entry carries
# its reason; an entry that suppresses nothing is a finding of its own
# ('allowlist'). Empty, as JAX's is: the port checks clean.
ALLOWLISTS: Dict[str, Dict[str, str]] = {}

DOCS = f'{PACKAGE}/docs'
OBSERVABILITY_DOC = f'{DOCS}/OBSERVABILITY.md'
TRANSPORT_DOC = f'{DOCS}/TRANSPORT.md'
STATIC_ANALYSIS_DOC = f'{DOCS}/STATIC_ANALYSIS.md'
# The lint module chip_smoke.py must run (the ci-wiring contract).
LINT_MODULE = f'{PACKAGE}.scripts.lint'
CI_SCRIPT = 'chip_smoke.py'


# --- shared AST helpers ----------------------------------------------


def _str_const(node) -> Optional[str]:
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return node.value
  return None


def _str_tuple(node) -> Optional[List[str]]:
  """Literal tuple/list of strings -> list, else None."""
  if isinstance(node, (ast.Tuple, ast.List)):
    out = []
    for elt in node.elts:
      s = _str_const(elt)
      if s is None:
        return None
      out.append(s)
    return out
  return None


def _int_tuple(node) -> Optional[List[int]]:
  if isinstance(node, (ast.Tuple, ast.List)):
    out = []
    for elt in node.elts:
      if not (isinstance(elt, ast.Constant)
              and isinstance(elt.value, int)):
        return None
      out.append(elt.value)
    return out
  return None


def _module_assign(tree: ast.AST, name: str) -> Optional[ast.AST]:
  """The value node of a module-level `name = ...` assignment."""
  for node in tree.body:  # type: ignore[attr-defined]
    if isinstance(node, ast.Assign):
      for tgt in node.targets:
        if isinstance(tgt, ast.Name) and tgt.id == name:
          return node.value
    elif isinstance(node, ast.AnnAssign):
      if (isinstance(node.target, ast.Name) and node.target.id == name
          and node.value is not None):
        return node.value
  return None


def _class_assign(tree: ast.AST, cls: str, name: str
                  ) -> Optional[ast.AST]:
  for node in ast.walk(tree):
    if isinstance(node, ast.ClassDef) and node.name == cls:
      for st in node.body:
        if isinstance(st, ast.Assign):
          for tgt in st.targets:
            if isinstance(tgt, ast.Name) and tgt.id == name:
              return st.value
  return None


_METRIC_NAME = re.compile(r'[a-z0-9_]+(?:/[a-z0-9_]+)+')


def registered_metric_names(ctx: CheckContext
                            ) -> Dict[str, Tuple[str, int]]:
  """Every literal-string telemetry registration in the port:
  {metric_name: (path, line)}. A registration is a call to
  `counter`/`gauge`/`histogram`, bare (telemetry.py itself) or as an
  attribute of `telemetry`/`_telemetry`; `writer.histogram` (the summary
  stream) is another surface. Computed once per CheckContext."""
  cached = getattr(ctx, '_registered_metric_names', None)
  if cached is not None:
    return cached
  out: Dict[str, Tuple[str, int]] = {}
  ctx._registered_metric_names = out
  for rel in ctx.package_sources():
    for node in ast.walk(ctx.tree(rel)):
      if not isinstance(node, ast.Call) or not node.args:
        continue
      fn = node.func
      if isinstance(fn, ast.Name):
        if fn.id not in ('counter', 'gauge', 'histogram'):
          continue
      elif isinstance(fn, ast.Attribute):
        if fn.attr not in ('counter', 'gauge', 'histogram'):
          continue
        if not (isinstance(fn.value, ast.Name)
                and fn.value.id in ('telemetry', '_telemetry')):
          continue
      else:
        continue
      name = _str_const(node.args[0])
      if name and _METRIC_NAME.fullmatch(name):
        out.setdefault(name, (rel, node.lineno))
  return out


def documented_metric_names(ctx: CheckContext) -> Set[str]:
  """Every backquoted `a/b` name in OBSERVABILITY.md."""
  return set(re.findall(r'`([a-z0-9_]+(?:/[a-z0-9_]+)+)`',
                        ctx.text(OBSERVABILITY_DOC)))


# --- 1. metric names <-> docs inventory ------------------------------


@checker('metric-names',
         'every telemetry counter/gauge/histogram registration in the '
         'port appears in the OBSERVABILITY.md inventory, and no '
         'documented name is orphaned')
def check_metric_names(ctx: CheckContext) -> List[Finding]:
  registered = registered_metric_names(ctx)
  documented = documented_metric_names(ctx)
  findings = []
  for name in sorted(set(registered) - documented):
    path, line = registered[name]
    findings.append(Finding(
        'metric-names', path, line, name,
        f'registered metric {name!r} is missing from the '
        f'{OBSERVABILITY_DOC} inventory'))
  for name in sorted(documented - set(registered)):
    findings.append(Finding(
        'metric-names', OBSERVABILITY_DOC, 1, name,
        f'documented metric {name!r} is no longer registered anywhere '
        f'in {PACKAGE}/'))
  return findings


# --- 2. SLO objectives <-> registry + docs table ---------------------


def slo_defaults(ctx: CheckContext) -> List[Tuple[str, str, int]]:
  """[(objective_name, metric, line)] from slo.DEFAULT_OBJECTIVES."""
  tree = ctx.tree(f'{PACKAGE}/slo.py')
  value = _module_assign(tree, 'DEFAULT_OBJECTIVES')
  out = []
  if value is None:
    return out
  for node in ast.walk(value):
    if isinstance(node, ast.Call):
      name = metric = None
      for kw in node.keywords:
        if kw.arg == 'name':
          name = _str_const(kw.value)
        elif kw.arg == 'metric':
          metric = _str_const(kw.value)
      if name and metric:
        out.append((name, metric, node.lineno))
  return out


def documented_objectives(ctx: CheckContext) -> Set[str]:
  """The objective names of OBSERVABILITY.md's SLO table (rows
  `| `name` | `metric/name` | ...`)."""
  return set(re.findall(
      r'^\|\s*`([a-z0-9_]+)`\s*\|\s*`[a-z0-9_]+(?:/[a-z0-9_]+)+`',
      ctx.text(OBSERVABILITY_DOC), re.MULTILINE))


@checker('slo-objectives',
         'every slo.DEFAULT_OBJECTIVES metric is a registered telemetry '
         'name, and the OBSERVABILITY.md SLO inventory table matches the '
         'default set by name, both directions')
def check_slo_objectives(ctx: CheckContext) -> List[Finding]:
  registered = set(registered_metric_names(ctx))
  defaults = slo_defaults(ctx)
  doc_names = documented_objectives(ctx)
  findings = []
  for name, metric, line in defaults:
    if metric not in registered:
      findings.append(Finding(
          'slo-objectives', f'{PACKAGE}/slo.py', line, name,
          f'objective {name!r} judges unregistered metric {metric!r}: '
          'it would evaluate no_data forever'))
  names = {n for n, _, _ in defaults}
  for name in sorted(names - doc_names):
    findings.append(Finding(
        'slo-objectives', f'{PACKAGE}/slo.py', 1, name,
        f'default objective {name!r} missing from the '
        f'{OBSERVABILITY_DOC} SLO inventory table'))
  for name in sorted(doc_names - names):
    findings.append(Finding(
        'slo-objectives', OBSERVABILITY_DOC, 1, name,
        f'documented SLO objective {name!r} is not in '
        'slo.DEFAULT_OBJECTIVES'))
  return findings


# --- 3. controller rules <-> objectives + actuators ------------------


@checker('controller-rules',
         'every controller.DEFAULT_RULES objective is a shipped SLO '
         'default and every actuator a KNOWN_ACTUATORS name')
def check_controller_rules(ctx: CheckContext) -> List[Finding]:
  path = f'{PACKAGE}/controller.py'
  tree = ctx.tree(path)
  slo_names = {n for n, _, _ in slo_defaults(ctx)}
  known = set(_str_tuple(_module_assign(tree, 'KNOWN_ACTUATORS')) or [])
  rules = _module_assign(tree, 'DEFAULT_RULES')
  if rules is None:
    return [Finding('controller-rules', path, 1, 'DEFAULT_RULES',
                    'DEFAULT_RULES not found as a module literal')]
  findings = []
  for node in ast.walk(rules):
    if not isinstance(node, ast.Call):
      continue
    for kw in node.keywords:
      val = _str_const(kw.value)
      if val is None:
        continue
      if kw.arg == 'objective' and val not in slo_names:
        findings.append(Finding(
            'controller-rules', path, node.lineno, val,
            f'rule watches objective {val!r} which is not in '
            'slo.DEFAULT_OBJECTIVES: it can never fire'))
      if kw.arg == 'actuator' and val not in known:
        findings.append(Finding(
            'controller-rules', path, node.lineno, val,
            f'rule drives unknown actuator {val!r} (not in '
            'KNOWN_ACTUATORS)'))
  return findings


# --- 4. config fields <-> the CLI's flags -----------------------------


def _config_fields(ctx: CheckContext) -> Dict[str, int]:
  fields: Dict[str, int] = {}
  for node in ast.walk(ctx.tree(f'{PACKAGE}/config.py')):
    if isinstance(node, ast.ClassDef) and node.name == 'Config':
      for st in node.body:
        if (isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)):
          fields[st.target.id] = st.lineno
  return fields


def _iterates_config_fields(loop: ast.For) -> bool:
  """`for <x> in dataclasses.fields(Config)` (or `fields(Config)`)."""
  it = loop.iter
  if not (isinstance(it, ast.Call) and it.args
          and isinstance(it.args[0], ast.Name)
          and it.args[0].id == 'Config'):
    return False
  fn = it.func
  return ((isinstance(fn, ast.Attribute) and fn.attr == 'fields')
          or (isinstance(fn, ast.Name) and fn.id == 'fields'))


def _skips_internal_fields(loop: ast.For) -> bool:
  """The loop's body starts a `continue` on `<x>.name in
  ...INTERNAL_FIELDS`."""
  for node in loop.body:
    if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
        and any(isinstance(op, ast.In) for op in node.test.ops)
        and any(isinstance(c, (ast.Name, ast.Attribute))
                and (getattr(c, 'id', None) == 'INTERNAL_FIELDS'
                     or getattr(c, 'attr', None) == 'INTERNAL_FIELDS')
                for c in node.test.comparators)
        and any(isinstance(b, ast.Continue) for b in node.body)):
      return True
  return False


def _derives_flags(loop: ast.For) -> bool:
  """The loop's body calls `add_argument(f'--{<x>.name}', ...)`."""
  for node in ast.walk(loop):
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr == 'add_argument' and node.args
        and isinstance(node.args[0], ast.JoinedStr)):
      parts = node.args[0].values
      if (len(parts) == 2 and _str_const(parts[0]) == '--'
          and isinstance(parts[1], ast.FormattedValue)
          and isinstance(parts[1].value, ast.Attribute)
          and parts[1].value.attr == 'name'):
        return True
  return False


@checker('config-flags',
         'every Config field is a CLI flag (experiment.py derives one '
         'per field) or named in config.INTERNAL_FIELDS; no literal flag '
         'spells a field; no stale INTERNAL_FIELDS entry')
def check_config_flags(ctx: CheckContext) -> List[Finding]:
  config_path = f'{PACKAGE}/config.py'
  experiment_path = f'{PACKAGE}/experiment.py'
  fields = _config_fields(ctx)
  internal_node = _module_assign(ctx.tree(config_path), 'INTERNAL_FIELDS')
  findings = []
  if internal_node is None:
    findings.append(Finding(
        'config-flags', config_path, 1, 'INTERNAL_FIELDS',
        'config.py must define the INTERNAL_FIELDS literal tuple (the '
        'explicit allowlist for fields deliberately not exposed as '
        'flags)'))
    internal = []
  else:
    internal = _str_tuple(internal_node) or []
  derived, skips = False, False
  literal: Dict[str, int] = {}
  for node in ast.walk(ctx.tree(experiment_path)):
    if (isinstance(node, ast.For) and _iterates_config_fields(node)
        and _derives_flags(node)):
      derived = True
      skips = skips or _skips_internal_fields(node)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr == 'add_argument' and node.args):
      name = _str_const(node.args[0])
      if name and name.startswith('--'):
        literal[name[2:]] = node.lineno
  flags = set(literal)
  if derived:
    flags |= set(fields) - (set(internal) if skips else set())
  for name in sorted(set(fields) - flags - set(internal)):
    findings.append(Finding(
        'config-flags', config_path, fields[name], name,
        f'Config.{name} has no CLI flag and no INTERNAL_FIELDS entry: '
        'operators cannot set it, and nothing records that as '
        'deliberate'))
  for name in sorted(set(literal) & set(fields)):
    findings.append(Finding(
        'config-flags', experiment_path, literal[name], name,
        f'flag --{name} spells Config.{name} by hand: the CLI derives '
        'one flag per field, so this one shadows or duplicates it'))
  for name in sorted(internal):
    if name not in fields:
      findings.append(Finding(
          'config-flags', config_path, 1, name,
          f'INTERNAL_FIELDS entry {name!r} is not a Config field: stale '
          'allowlist entry'))
    elif name in flags:
      findings.append(Finding(
          'config-flags', config_path, 1, name,
          f'INTERNAL_FIELDS entry {name!r} HAS a flag (the CLI\'s '
          'derivation does not skip INTERNAL_FIELDS): the allowlist '
          'entry is stale'))
  return findings


# --- 5. validate_* coverage in driver.train AND driver.evaluate ------


@checker('validate-coverage',
         'every config.validate_* knob group is called from both '
         'driver.train and driver.evaluate')
def check_validate_coverage(ctx: CheckContext) -> List[Finding]:
  groups: Dict[str, int] = {}
  for node in ctx.tree(f'{PACKAGE}/config.py').body:  # type: ignore
    if (isinstance(node, ast.FunctionDef)
        and node.name.startswith('validate_')):
      groups[node.name] = node.lineno
  driver_path = f'{PACKAGE}/driver.py'
  drv = ctx.tree(driver_path)
  findings = []
  for entry in ('train', 'evaluate'):
    fn = next((n for n in drv.body  # type: ignore[attr-defined]
               if isinstance(n, ast.FunctionDef) and n.name == entry),
              None)
    if fn is None:
      findings.append(Finding('validate-coverage', driver_path, 1, entry,
                              f'driver.{entry} not found'))
      continue
    called = set()
    for node in ast.walk(fn):
      if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
          called.add(f.id)
        elif isinstance(f, ast.Attribute):
          called.add(f.attr)
    for group in sorted(set(groups) - called):
      findings.append(Finding(
          'validate-coverage', driver_path, fn.lineno, f'{entry}:{group}',
          f'driver.{entry} never calls config.{group}: a bad knob in '
          'that group passes spin-up silently on this path'))
  return findings


# --- 6. durable incident markers <-> emitters <-> docs ---------------


def emitted_incident_kinds(ctx: CheckContext
                           ) -> Dict[str, Tuple[str, int]]:
  """Literal incident kinds: first arguments of `<x>.event('kind', ...)`
  anywhere in the port (its scripts included), and literal kinds handed
  to an incident `sink(...)` (the lock-order runtime's seam)."""
  kinds: Dict[str, Tuple[str, int]] = {}
  for rel in ctx.package_sources():
    for node in ast.walk(ctx.tree(rel)):
      if not isinstance(node, ast.Call) or not node.args:
        continue
      f = node.func
      is_event = isinstance(f, ast.Attribute) and f.attr == 'event'
      is_sink = isinstance(f, ast.Name) and f.id == 'sink'
      if not (is_event or is_sink):
        continue
      kind = _str_const(node.args[0])
      if kind:
        kinds.setdefault(kind, (rel, node.lineno))
  return kinds


def documented_durable_markers(ctx: CheckContext) -> Set[str]:
  m = re.search(r'### Durable incident markers\n(.*?)(?:\n#|\Z)',
                ctx.text(OBSERVABILITY_DOC), re.S)
  if not m:
    return set()
  return set(re.findall(r'`([a-z0-9_]+)`', m.group(1)))


@checker('durable-markers',
         'every EventLog._DURABLE_MARKERS marker matches an incident kind '
         'the port emits, and the OBSERVABILITY.md durable-marker list '
         'matches the code both directions')
def check_durable_markers(ctx: CheckContext) -> List[Finding]:
  path = f'{PACKAGE}/observability.py'
  node = _class_assign(ctx.tree(path), 'EventLog', '_DURABLE_MARKERS')
  markers = _str_tuple(node) if node is not None else None
  if markers is None:
    return [Finding('durable-markers', path, 1, '_DURABLE_MARKERS',
                    'EventLog._DURABLE_MARKERS literal tuple not found')]
  findings = []
  kinds = emitted_incident_kinds(ctx)
  for marker in sorted(markers):
    if not any(marker in kind for kind in kinds):
      findings.append(Finding(
          'durable-markers', path, node.lineno, marker,
          f'durable marker {marker!r} matches no emitted incident kind '
          f'anywhere in {PACKAGE}/: orphaned fsync rule'))
  documented = documented_durable_markers(ctx)
  if not documented:
    findings.append(Finding(
        'durable-markers', OBSERVABILITY_DOC, 1, 'durable-markers-section',
        f'{OBSERVABILITY_DOC} has no "### Durable incident markers" '
        'section listing the fsync markers'))
    return findings
  for marker in sorted(set(markers) - documented):
    findings.append(Finding(
        'durable-markers', OBSERVABILITY_DOC, 1, marker,
        f'durable marker {marker!r} (code) missing from the '
        f'{OBSERVABILITY_DOC} durable-marker list'))
  for marker in sorted(documented - set(markers)):
    findings.append(Finding(
        'durable-markers', OBSERVABILITY_DOC, 1, marker,
        f'documented durable marker {marker!r} is not in '
        'EventLog._DURABLE_MARKERS'))
  return findings


# --- 7. protocol versions <-> TRANSPORT.md table ---------------------


def documented_protocol_versions(ctx: CheckContext) -> Set[int]:
  """The versions of TRANSPORT.md's table (rows `| vN |`)."""
  return {int(v) for v in re.findall(r'^\|\s*v(\d+)\s*\|',
                                     ctx.text(TRANSPORT_DOC), re.M)}


@checker('protocol-versions',
         "remote.py's _COMPATIBLE_PROTOCOLS matches the TRANSPORT.md "
         'version table both directions, and PROTOCOL_VERSION is the '
         'newest compatible version')
def check_protocol_versions(ctx: CheckContext) -> List[Finding]:
  path = f'{PACKAGE}/runtime/remote.py'
  tree = ctx.tree(path)
  compat_node = _module_assign(tree, '_COMPATIBLE_PROTOCOLS')
  compat = _int_tuple(compat_node) if compat_node is not None else None
  current_node = _module_assign(tree, 'PROTOCOL_VERSION')
  if compat is None or not isinstance(current_node, ast.Constant):
    return [Finding('protocol-versions', path, 1, '_COMPATIBLE_PROTOCOLS',
                    '_COMPATIBLE_PROTOCOLS / PROTOCOL_VERSION literals '
                    'not found')]
  current = current_node.value
  doc_versions = documented_protocol_versions(ctx)
  if not doc_versions:
    return [Finding('protocol-versions', TRANSPORT_DOC, 1, 'version-table',
                    f'{TRANSPORT_DOC} has no protocol version table (rows '
                    'starting `| vN |`)')]
  findings = []
  for v in sorted(set(compat) - doc_versions):
    findings.append(Finding(
        'protocol-versions', path, compat_node.lineno, f'v{v}',
        f'protocol v{v} is in _COMPATIBLE_PROTOCOLS but missing from the '
        f'{TRANSPORT_DOC} version table'))
  for v in sorted(doc_versions - set(compat)):
    findings.append(Finding(
        'protocol-versions', TRANSPORT_DOC, 1, f'v{v}',
        f'{TRANSPORT_DOC} documents protocol v{v} which is not in '
        '_COMPATIBLE_PROTOCOLS'))
  if current != max(compat):
    findings.append(Finding(
        'protocol-versions', path, compat_node.lineno, f'v{current}',
        f'PROTOCOL_VERSION ({current}) is not the newest compatible '
        f'version ({max(compat)})'))
  return findings


# --- 8. driver summary scalars <-> docs inventory --------------------

SUMMARY_BLOCK_BEGIN = '<!-- lint:summary-scalars:begin -->'
SUMMARY_BLOCK_END = '<!-- lint:summary-scalars:end -->'


def _dict_keys(node, loop_names) -> List[str]:
  """The literal keys of a `scalars({...})` argument: a dict display's
  string keys, or a comprehension's over a literal tuple (directly or
  through a name a `for` loop binds to one)."""
  if isinstance(node, ast.Dict):
    return [k for k in map(_str_const, node.keys) if k is not None]
  if isinstance(node, ast.DictComp) and len(node.generators) == 1:
    gen = node.generators[0]
    key = node.key
    if (isinstance(gen.target, ast.Name) and isinstance(key, ast.Name)
        and key.id == gen.target.id):
      vals = _str_tuple(gen.iter)
      if vals is None and isinstance(gen.iter, ast.Name):
        vals = loop_names.get(gen.iter.id)
      return list(vals or [])
  return []


def driver_summary_tags(ctx: CheckContext) -> Dict[str, int]:
  """Literal summary-scalar tags the port's driver writes: first
  arguments of `.scalar(tag, value, step)` (literals, or names a `for`
  loop binds to a literal tuple, as JAX's), and the literal keys of
  `.scalars({...}, step)` (a dict display, or a comprehension over a
  literal tuple). Tags known only at run time (per-level episode tags,
  the tracer's span percentiles, the learner's step metrics, the replay
  tier's stats) are outside the static contract and named in prose in
  the doc."""
  tree = ctx.tree(f'{PACKAGE}/driver.py')
  loop_names: Dict[str, List[str]] = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
      vals = _str_tuple(node.iter)
      if vals:
        loop_names.setdefault(node.target.id, []).extend(vals)
  tags: Dict[str, int] = {}
  for node in ast.walk(tree):
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute) and node.args):
      continue
    arg = node.args[0]
    if node.func.attr == 'scalar':
      lit = _str_const(arg)
      if lit is not None:
        tags.setdefault(lit, node.lineno)
      elif isinstance(arg, ast.Name) and arg.id in loop_names:
        for val in loop_names[arg.id]:
          tags.setdefault(val, node.lineno)
    elif node.func.attr == 'scalars':
      for key in _dict_keys(arg, loop_names):
        tags.setdefault(key, node.lineno)
  return tags


def documented_summary_tags(ctx: CheckContext) -> Set[str]:
  doc = ctx.text(OBSERVABILITY_DOC)
  start = doc.find(SUMMARY_BLOCK_BEGIN)
  end = doc.find(SUMMARY_BLOCK_END)
  if start < 0 or end < 0:
    return set()
  # Tags may be namespaced with '/' (e.g. population/best_return).
  return set(re.findall(r'`([a-z0-9_/]+)`', doc[start:end]))


@checker('summary-scalars',
         'every literal summary-scalar tag the driver writes appears in '
         'the generated OBSERVABILITY.md inventory block (the lint '
         'module\'s --fix-docs regenerates it), and no documented tag is '
         'orphaned')
def check_summary_scalars(ctx: CheckContext) -> List[Finding]:
  tags = driver_summary_tags(ctx)
  documented = documented_summary_tags(ctx)
  if not documented:
    return [Finding(
        'summary-scalars', OBSERVABILITY_DOC, 1, 'summary-scalar-block',
        f'{OBSERVABILITY_DOC} has no generated summary-scalar inventory '
        f'block ({SUMMARY_BLOCK_BEGIN} ... {SUMMARY_BLOCK_END}): run the '
        'lint module with --fix-docs')]
  findings = []
  for tag in sorted(set(tags) - documented):
    findings.append(Finding(
        'summary-scalars', f'{PACKAGE}/driver.py', tags[tag], tag,
        f'driver writes summary scalar {tag!r} which is missing from the '
        f'{OBSERVABILITY_DOC} inventory block (run the lint module with '
        '--fix-docs)'))
  for tag in sorted(documented - set(tags)):
    findings.append(Finding(
        'summary-scalars', OBSERVABILITY_DOC, 1, tag,
        f'documented summary scalar {tag!r} is no longer written by '
        'driver.py (run the lint module with --fix-docs)'))
  return findings


def fix_summary_scalar_docs(ctx: CheckContext) -> bool:
  """Regenerate the summary-scalar block of OBSERVABILITY.md from the
  live driver's tags. Returns True when the file changed."""
  tags = sorted(driver_summary_tags(ctx))
  body = '\n'.join([SUMMARY_BLOCK_BEGIN] + [f'- `{t}`' for t in tags]
                   + [SUMMARY_BLOCK_END])
  path = ctx.root / OBSERVABILITY_DOC
  doc = path.read_text()
  start = doc.find(SUMMARY_BLOCK_BEGIN)
  end = doc.find(SUMMARY_BLOCK_END)
  if start < 0 or end < 0:
    raise SystemExit(f'{OBSERVABILITY_DOC} has no summary-scalar block '
                     'markers; add the section first (see '
                     f'{STATIC_ANALYSIS_DOC})')
  new = doc[:start] + body + doc[end + len(SUMMARY_BLOCK_END):]
  if new != doc:
    path.write_text(new)
    return True
  return False


# --- 9. checker inventory <-> STATIC_ANALYSIS.md ---------------------


@checker('checker-inventory',
         'the STATIC_ANALYSIS.md checker table matches the lint module\'s '
         '--list both directions')
def check_checker_inventory(ctx: CheckContext) -> List[Finding]:
  from scalable_agent_tpu_torch import analysis
  names = {n for n, _, _ in analysis.all_checkers()}
  try:
    doc = ctx.text(STATIC_ANALYSIS_DOC)
  except FileNotFoundError:
    return [Finding('checker-inventory', STATIC_ANALYSIS_DOC, 1, 'docs',
                    f'{STATIC_ANALYSIS_DOC} does not exist')]
  doc_names = set(re.findall(r'^\|\s*`([a-z0-9-]+)`\s*\|', doc, re.M))
  findings = []
  for name in sorted(names - doc_names):
    findings.append(Finding(
        'checker-inventory', STATIC_ANALYSIS_DOC, 1, name,
        f'checker {name!r} is missing from the {STATIC_ANALYSIS_DOC} '
        'inventory table'))
  for name in sorted(doc_names - names):
    findings.append(Finding(
        'checker-inventory', STATIC_ANALYSIS_DOC, 1, name,
        f'documented checker {name!r} is not registered in the analysis '
        'framework'))
  return findings


# --- 10. the CI's wiring: chip_smoke.py runs the lint module ---------


@checker('ci-wiring',
         'chip_smoke.py (the port\'s CI on the card) runs the lint '
         'module as a process and carries no checker of its own')
def check_ci_wiring(ctx: CheckContext) -> List[Finding]:
  try:
    tree = ctx.tree(CI_SCRIPT)
  except FileNotFoundError:
    return [Finding('ci-wiring', CI_SCRIPT, 1, 'ci-script',
                    f'{CI_SCRIPT} does not exist')]
  findings = []
  if not any(_str_const(node) == LINT_MODULE for node in ast.walk(tree)):
    findings.append(Finding(
        'ci-wiring', CI_SCRIPT, 1, 'lint-call',
        f'{CI_SCRIPT} never runs {LINT_MODULE}'))
  for node in ast.walk(tree):
    inline = None
    if isinstance(node, ast.Call):
      f = node.func
      name = f.id if isinstance(f, ast.Name) else (
          f.attr if isinstance(f, ast.Attribute) else None)
      if name in ('checker', 'run_checks'):
        inline = f'{name}(...)'
    elif isinstance(node, ast.ImportFrom) and node.module in (
        f'{PACKAGE}.analysis', f'{PACKAGE}.analysis.contracts',
        f'{PACKAGE}.analysis.concurrency'):
      # analysis.runtime (the lock-order runtime) is no checker.
      names = [a.name for a in node.names if a.name != 'runtime']
      if names:
        inline = f'from {node.module} import {", ".join(names)}'
    elif isinstance(node, ast.ImportFrom) and node.module == PACKAGE and (
        any(a.name == 'analysis' for a in node.names)):
      inline = f'from {PACKAGE} import analysis'
    if inline:
      findings.append(Finding(
          'ci-wiring', CI_SCRIPT, node.lineno, 'inline-checker',
          f'{CI_SCRIPT} runs the analysis framework itself ({inline}): '
          f'the checks live in {LINT_MODULE}, run as a process'))
  return findings


# --- 11. the sharding registry ----------------------------------------


@checker('sharding-registry',
         'no ShardingRegistry(...) construction outside '
         'parallel/sharding.py: every consumer resolves its specs through '
         'the one registry sharding.from_config builds')
def check_sharding_registry(ctx: CheckContext) -> List[Finding]:
  """parallel/sharding.py is the one source of sharding decisions. The
  port's spec is a plain tuple, which the AST cannot tell from any other
  tuple; what it can see is a registry built with private rules
  somewhere else, which every consumer of the real one would miss."""
  home = f'{PACKAGE}/parallel/sharding.py'
  sources = ctx.package_sources()
  if (ctx.root / CI_SCRIPT).exists():
    sources.append(CI_SCRIPT)
  findings = []
  for rel in sources:
    if rel.replace('\\', '/') == home:
      continue
    tree = ctx.tree(rel)
    aliases: Set[str] = set()
    for node in ast.walk(tree):
      if isinstance(node, ast.ImportFrom) and node.module and (
          node.module.endswith('sharding')):
        for a in node.names:
          if a.name == 'ShardingRegistry':
            aliases.add(a.asname or a.name)
    built = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and ((isinstance(node.func, ast.Name) and node.func.id in aliases)
                  or (isinstance(node.func, ast.Attribute)
                      and node.func.attr == 'ShardingRegistry'))]
    if not built:
      continue
    func_of: Dict[int, str] = {}
    for node in ast.walk(tree):
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for sub in ast.walk(node):
          if hasattr(sub, 'lineno'):
            func_of.setdefault(sub.lineno, node.name)
    for node in built:
      where = func_of.get(node.lineno, '<module>')
      findings.append(Finding(
          'sharding-registry', rel, node.lineno, f'{rel}:{where}',
          'inline ShardingRegistry construction outside '
          'parallel/sharding.py: resolve the specs through the sharding '
          'registry (sharding.from_config) so every consumer sees the same '
          'decision'))
  return findings
