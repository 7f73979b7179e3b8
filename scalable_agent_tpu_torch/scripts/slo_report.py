"""The SLO verdict report: the go/no-go of a run.

    python -m scalable_agent_tpu_torch.scripts.slo_report LOGDIR [--json OUT.json]
                                      [--update-fps-baseline BASELINE.json]

1. The verdict gate: reads the run's SLO_VERDICT.json (written by the
   SLO engine of `driver.train`, slo.py) and prints the table of
   objectives (state, value, target, margin, burns) and the triggered
   captures. A failing verdict exits 1 and names the violated
   objectives.
2. Baseline upkeep (`--update-fps-baseline`): records the run's
   steady-state env frames/s (the median of the second half of its
   `env_frames_per_sec` summaries) into the per-host baseline file the
   `fps_floor` objective judges later runs against
   (`slo.update_baseline`). Only do this from a run you would accept as
   the floor.

The JAX package's report also gates a benchmark headline against its
bench history (`--bench`). That gate waits for the port's own benchmark:
the port has no benchmark record yet, and this tool has no `--bench`.

Exit codes: 0 the verdict passes, 1 it fails, 2 no verdict in LOGDIR.
"""

import argparse
import json
import math
import os
import sys


def _fmt(v, digits=4):
  if v is None:
    return '-'
  try:
    f = float(v)
  except (TypeError, ValueError):
    return str(v)
  if math.isnan(f):
    return '-'
  return f'{f:.{digits}g}'


def verdict_rows(verdict):
  """One row per objective, in name order."""
  rows = []
  for name, e in sorted(verdict.get('objectives', {}).items()):
    rows.append({
        'objective': name,
        'severity': e.get('severity'),
        'state': e.get('state'),
        'value': e.get('value'),
        'target': e.get('target'),
        'margin': e.get('margin'),
        'burns': e.get('burns', 0),
        'metric': e.get('metric'),
    })
  return rows


def render_verdict(verdict):
  out = []
  w = out.append
  w('== SLO verdict: %s ==' % ('PASS' if verdict.get('pass') else 'FAIL'))
  w(f"{'objective':>28} {'sev':>7} {'state':>12} {'value':>12} "
    f"{'target':>12} {'margin':>12} {'burns':>6}")
  for row in verdict_rows(verdict):
    w(f"{row['objective']:>28} {row['severity']:>7} "
      f"{row['state']:>12} {_fmt(row['value']):>12} "
      f"{_fmt(row['target']):>12} {_fmt(row['margin']):>12} "
      f"{row['burns']:>6}")
  captures = verdict.get('captures') or {}
  if captures:
    w('-- triggered captures --')
    for name, cap in sorted(captures.items()):
      w(f'  {name}:')
      for kind in ('flight', 'trace_slice', 'profile'):
        w(f'    {kind}: {cap.get(kind) or "-"}')
  violations = verdict.get('violations') or []
  if violations:
    w('violated objectives: ' + ', '.join(violations))
  return '\n'.join(out)


def measured_fps(logdir):
  """The run's steady-state env frames/s: the median of the second half
  of its env_frames_per_sec summaries (the first half is warm-up), or
  None without any."""
  values = []
  try:
    with open(os.path.join(logdir, 'summaries.jsonl')) as f:
      for line in f:
        line = line.strip()
        if not line:
          continue
        try:
          e = json.loads(line)
        except ValueError:
          continue
        if e.get('tag') == 'env_frames_per_sec':
          values.append(float(e['value']))
  except OSError:
    return None
  if not values:
    return None
  tail = sorted(values[len(values) // 2:])
  return tail[len(tail) // 2]


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.slo_report',
      description='SLO verdict report of a run')
  parser.add_argument('logdir', help='run directory (has SLO_VERDICT.json)')
  parser.add_argument('--json', default=None,
                      help='also write the report here')
  parser.add_argument('--update-fps-baseline', default=None,
                      help="record this run's measured env frames/s into "
                           'the per-host baseline file the fps_floor '
                           'objective reads')
  args = parser.parse_args(argv)

  from scalable_agent_tpu_torch import slo as slo_lib

  verdict = slo_lib.read_verdict(args.logdir)
  if verdict is None:
    print(f'no SLO_VERDICT.json under {args.logdir!r} — was the run '
          'started with --slo_engine=false?', file=sys.stderr)
    return 2
  print(render_verdict(verdict))
  failed = not verdict.get('pass', False)
  report = {'logdir': args.logdir, 'slo_pass': verdict.get('pass'),
            'violations': verdict.get('violations') or [],
            'objectives': verdict_rows(verdict)}

  if args.update_fps_baseline:
    fps = measured_fps(args.logdir)
    if fps is None:
      print('\nno env_frames_per_sec summaries to record as a baseline',
            file=sys.stderr)
    else:
      path = slo_lib.update_baseline(args.update_fps_baseline,
                                     {'fps': fps})
      report['fps_baseline'] = {'fps': fps, 'path': path}
      print(f'\nrecorded fps baseline {fps:,.1f} for this host into '
            f'{path}')

  if args.json:
    with open(args.json, 'w') as f:
      json.dump(report, f, indent=2, default=str)
    print(f'\nreport JSON: {args.json}')
  return 1 if failed else 0


if __name__ == '__main__':
  sys.exit(main())
