"""The port's static contract lint: every checker of
`scalable_agent_tpu_torch.analysis` over the repo.

    python -m scalable_agent_tpu_torch.scripts.lint            # every checker
    python -m scalable_agent_tpu_torch.scripts.lint --check metric-names --check guarded-by
    python -m scalable_agent_tpu_torch.scripts.lint --json     # findings as a JSON list
    python -m scalable_agent_tpu_torch.scripts.lint --list     # the checker inventory
    python -m scalable_agent_tpu_torch.scripts.lint --fix-docs # regenerate the
                                                               # summary-scalar block,
                                                               # then lint

Run from anywhere: it lints the repo that holds the package. Exit
status: 0 clean, 1 findings, 2 a usage error (an unknown checker). The
inventory `--list` prints is itself held against the port's
STATIC_ANALYSIS.md by the `checker-inventory` checker.
"""

import argparse
import json
import os
import sys

from scalable_agent_tpu_torch import analysis
from scalable_agent_tpu_torch.analysis import CheckContext, contracts

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.lint',
      description='AST-based contract lint of the port '
                  f'({contracts.STATIC_ANALYSIS_DOC})')
  parser.add_argument('--check', action='append', default=[],
                      metavar='NAME',
                      help='run only this checker (repeatable)')
  parser.add_argument('--json', action='store_true',
                      help='print the findings as a JSON list')
  parser.add_argument('--list', action='store_true',
                      help='print the checker inventory and exit')
  parser.add_argument('--fix-docs', action='store_true',
                      help='regenerate the generated doc blocks (summary '
                           'scalars) before linting')
  parser.add_argument('--root', default=_ROOT, help=argparse.SUPPRESS)
  args = parser.parse_args(argv)

  if args.list:
    for name, description, _ in analysis.all_checkers():
      print(f'{name}: {description}')
    return 0

  if args.fix_docs:
    changed = contracts.fix_summary_scalar_docs(CheckContext(args.root))
    print(f'{contracts.OBSERVABILITY_DOC} summary-scalar block '
          + ('REGENERATED' if changed else 'already current'),
          file=sys.stderr)

  try:
    findings = analysis.run_checks(args.root, only=args.check or None)
  except ValueError as e:
    print(f'lint: {e}', file=sys.stderr)
    return 2

  if args.json:
    print(json.dumps([vars(f) for f in findings], indent=2))
  else:
    for f in findings:
      print(f.render())
    n_checks = len(args.check) if args.check else len(
        analysis.all_checkers())
    if findings:
      print(f'lint: {len(findings)} finding(s) across {n_checks} '
            'checker(s)', file=sys.stderr)
    else:
      print(f'lint OK: {n_checks} checker(s), no findings',
            file=sys.stderr)
  return 1 if findings else 0


if __name__ == '__main__':
  sys.exit(main())
